"""RGW bucket notifications (reference src/rgw/rgw_notify.cc +
rgw_pubsub.cc, reduced to the http-push core).

Model (the reference's shape):
  topic      named push destination (here: an http endpoint — the
             reference also speaks amqp/kafka)
  binding    per-bucket notification config: topic + event filter
             (s3:ObjectCreated:*, s3:ObjectRemoved:*) + optional key
             prefix
  delivery   events publish into a per-topic cls_journal queue and a
             background pusher POSTs them to the endpoint with
             at-least-once semantics (the queue position only advances
             after a 2xx), mirroring the reference's persistent-topic
             reservation/commit flow

Event payload follows the S3 event-record shape (eventName,
s3.bucket.name, s3.object.key/size) so receivers written for S3 can
parse it.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

from .store import RGWError, RGWStore

TOPICS_OBJ = "rgw_topics"


class NotificationManager:
    """Owns topics + bucket bindings + the delivery pusher for one
    zone.  Attach with RGWStore.enable_notifications()."""

    def __init__(self, store: RGWStore, push_interval: float = 0.25):
        self.store = store
        self.meta = store.meta
        self.meta.execute(TOPICS_OBJ, "rgw", "dir_init", b"")
        self._stop = threading.Event()
        self._pusher = threading.Thread(
            target=self._push_loop, daemon=True, name="rgw-notify")
        self.push_interval = push_interval
        self.delivered = 0            # observability/tests
        self._topics_cache: tuple[float, dict] | None = None
        self._draining: set[str] = set()   # per-topic isolation
        self._drain_lock = threading.Lock()
        self._pusher.start()

    def shutdown(self) -> None:
        self._stop.set()
        self._pusher.join(5)

    # -- topics (reference rgw_pubsub topics) -------------------------------

    def create_topic(self, name: str, endpoint: str) -> None:
        self.store._cls(self.meta, TOPICS_OBJ, "dir_add", {
            "key": name, "meta": {"endpoint": endpoint}})
        self.meta.execute(f"topic.{name}", "journal", "create", b"")
        self.meta.execute(
            f"topic.{name}", "journal", "client_register",
            json.dumps({"id": "pusher", "pos": -1}).encode())
        self._topics_cache = None

    def topics(self, max_age: float = 1.0) -> dict[str, dict]:
        now = time.time()
        if self._topics_cache is not None and \
                now - self._topics_cache[0] < max_age:
            return self._topics_cache[1]
        raw = self.store._cls(self.meta, TOPICS_OBJ, "dir_list",
                              {"max": 10000})
        out = {k: m for k, m in json.loads(raw.decode())["entries"]}
        self._topics_cache = (now, out)
        return out

    def delete_topic(self, name: str) -> None:
        try:
            self.store._cls(self.meta, TOPICS_OBJ, "dir_rm",
                            {"key": name})
        except Exception:  # noqa: BLE001 - absent already
            pass
        # the queue dies with the topic: stale bucket bindings keep
        # matching but publish() filters them against topics(), so
        # nothing appends to (or leaks in) an orphan journal
        try:
            self.meta.remove(f"topic.{name}")
        except Exception:  # noqa: BLE001
            pass
        self._topics_cache = None

    # -- bucket bindings (reference bucket notification conf) ---------------

    def put_bucket_notification(self, bucket: str,
                                configs: list[dict]) -> None:
        """configs: [{"id", "topic", "events": [...], "prefix": ""}].
        Stored on the bucket meta row like acl/policy/lifecycle."""
        known = self.topics()
        for c in configs:
            if c.get("topic") not in known:
                raise RGWError(400, "InvalidArgument",
                               f"unknown topic {c.get('topic')!r}")
            for ev in c.get("events", []):
                if not ev.startswith("s3:Object"):
                    raise RGWError(400, "InvalidArgument",
                                   f"unsupported event {ev!r}")
        with self.store._bmeta_lock:
            meta = self.store._bucket_meta(bucket)
            if meta is None:
                raise RGWError(404, "NoSuchBucket", bucket)
            if configs:
                meta["notifications"] = configs
            else:
                meta.pop("notifications", None)
            from .store import BUCKETS_OBJ
            self.store._cls(self.meta, BUCKETS_OBJ, "dir_add", {
                "key": bucket, "meta": meta})

    def get_bucket_notification(self, bucket: str) -> list[dict]:
        meta = self.store._bucket_meta(bucket)
        if meta is None:
            raise RGWError(404, "NoSuchBucket", bucket)
        return meta.get("notifications", [])

    # -- event publication (store hooks call this) --------------------------

    @staticmethod
    def _matches(cfg: dict, event: str, key: str) -> bool:
        if key and not key.startswith(cfg.get("prefix", "")):
            return False
        wanted = cfg.get("events") or ["s3:Object*"]
        return any(event == w or
                   (w.endswith("*") and event.startswith(w[:-1]))
                   for w in wanted)

    def publish(self, bucket: str, key: str, event: str,
                size: int = 0, bmeta: dict | None = None) -> None:
        meta = bmeta if bmeta is not None \
            else self.store._bucket_meta(bucket)
        if not meta or not meta.get("notifications"):
            return
        import datetime
        iso = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.%fZ")     # S3 carries ISO8601, not epoch
        record = {
            "eventVersion": "2.2", "eventSource": "ceph_tpu:rgw",
            "eventTime": iso, "eventName": event,
            "s3": {"bucket": {"name": bucket},
                   "object": {"key": key, "size": size}},
        }
        live = self.topics()
        for cfg in meta["notifications"]:
            if cfg["topic"] in live and \
                    self._matches(cfg, event, key):
                self.meta.execute(
                    f"topic.{cfg['topic']}", "journal", "append",
                    json.dumps({"entry": {"cfg_id": cfg.get("id"),
                                          "record": record}}).encode())

    # -- delivery (reference persistent-topic push with commit) -------------

    def _push_loop(self) -> None:
        while not self._stop.wait(self.push_interval):
            try:
                # one drain thread per topic: a hung endpoint must not
                # stall every other topic's delivery for its timeout
                for name, tmeta in self.topics().items():
                    with self._drain_lock:
                        if name in self._draining:
                            continue
                        self._draining.add(name)
                    threading.Thread(
                        target=self._drain_guarded,
                        args=(name, tmeta["endpoint"]), daemon=True,
                        name=f"rgw-notify-{name}").start()
            except Exception:  # noqa: BLE001 - zone shutting down etc.
                continue

    def _drain_guarded(self, name: str, endpoint: str) -> None:
        try:
            self._drain_topic(name, endpoint)
        except Exception:  # noqa: BLE001 - topic deleted mid-drain
            pass
        finally:
            with self._drain_lock:
                self._draining.discard(name)

    def _drain_topic(self, name: str, endpoint: str,
                     batch: int = 64) -> None:
        oid = f"topic.{name}"
        raw = self.meta.execute(oid, "journal", "client_get",
                                json.dumps({"id": "pusher"}).encode())
        pos = int(json.loads(raw.decode())["pos"])
        raw = self.meta.execute(
            oid, "journal", "list",
            json.dumps({"after_seq": pos, "max": batch}).encode())
        entries = json.loads(raw.decode())["entries"]
        last_ok = None
        for seq, entry in entries:
            body = json.dumps({"Records": [entry["record"]]}).encode()
            req = urllib.request.Request(
                endpoint, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                # non-2xx raises HTTPError, landing in the except arm
                with urllib.request.urlopen(req, timeout=10):
                    pass
            except Exception:  # noqa: BLE001 - receiver down/erroring:
                break                     # at-least-once, retry later
            last_ok = seq
            self.delivered += 1
        if last_ok is not None:
            # ONE commit + trim per drained batch (position only moves
            # past what actually got a 2xx — commit-after-push)
            self.meta.execute(
                oid, "journal", "client_update",
                json.dumps({"id": "pusher", "pos": last_ok}).encode())
            self.meta.execute(oid, "journal", "trim",
                              json.dumps({"to_seq": last_ok}).encode())
