"""Prometheus-format metrics exporter (mgr prometheus module role).

Re-expresses the reference's mgr prometheus module
(src/pybind/mgr/prometheus/): scrapes every daemon's perf counters via
their admin sockets and serves them as prometheus text exposition on
an HTTP endpoint.

  python -m ceph_tpu_torch.tools.metrics_exporter --asok-dir DIR --port 9283
"""

from __future__ import annotations

import argparse
import glob
import http.server
import os
import sys

from ..common.perf_counters import (LATENCY_QUANTILES,
                                    quantile_from_cumulative)


# perf-counter type -> prometheus metric type (u64 counters are
# monotonic; gauges settable; time/avg expand to _sum/_count pairs,
# which prometheus models as counters; hist is a native histogram)
_PROM_TYPE = {"u64": "counter", "gauge": "gauge",
              "time": "counter", "avg": "counter",
              "hist": "histogram"}

# Cumulative scrape failures per daemon, for the whole exporter
# process lifetime: a daemon whose asok stops answering must be
# VISIBLE (daemon_up 0 + a rising error counter), not silently absent
# from the exposition.
_SCRAPE_ERRORS: dict[str, int] = {}


def collect(asok_dir: str) -> str:
    from ..common.admin_socket import admin_command
    lines = [
        "# HELP ceph_tpu_perf daemon perf counters",
    ]
    typed: set[str] = set()

    def emit_type(name: str, ctype: str | None) -> None:
        if name in typed:
            return
        typed.add(name)
        lines.append(f"# TYPE {name} "
                     f"{_PROM_TYPE.get(ctype, 'untyped')}")

    for path in sorted(glob.glob(os.path.join(asok_dir, "*.asok"))):
        daemon = os.path.basename(path).rsplit(".asok", 1)[0]
        dlabel = f'{{daemon="{daemon}"}}'
        try:
            dump = admin_command(path, {"prefix": "perf dump"}, timeout=2)
        except Exception:  # noqa: BLE001 - daemon down: say so
            _SCRAPE_ERRORS[daemon] = _SCRAPE_ERRORS.get(daemon, 0) + 1
            emit_type("ceph_tpu_daemon_up", "gauge")
            lines.append(f"ceph_tpu_daemon_up{dlabel} 0")
            emit_type("ceph_tpu_scrape_errors_total", "u64")
            lines.append(f"ceph_tpu_scrape_errors_total{dlabel} "
                         f"{_SCRAPE_ERRORS[daemon]}")
            continue
        emit_type("ceph_tpu_daemon_up", "gauge")
        lines.append(f"ceph_tpu_daemon_up{dlabel} 1")
        if daemon in _SCRAPE_ERRORS:
            emit_type("ceph_tpu_scrape_errors_total", "u64")
            lines.append(f"ceph_tpu_scrape_errors_total{dlabel} "
                         f"{_SCRAPE_ERRORS[daemon]}")
        try:
            schema = admin_command(path, {"prefix": "perf schema"},
                                   timeout=2)
        except Exception:  # noqa: BLE001 - older daemon: untyped
            schema = {}
        for group, counters in dump.items():
            if not isinstance(counters, dict):
                continue
            gschema = schema.get(group, {}) if isinstance(schema, dict) \
                else {}
            for key, val in counters.items():
                name = f"ceph_tpu_{key}"
                ctype = gschema.get(key)
                labels = f'{{daemon="{daemon}",group="{group}"}}'
                if isinstance(val, dict) and "buckets" in val:
                    # histogram: cumulative le buckets + sum/count
                    emit_type(name, "hist")
                    for le, cum in val["buckets"]:
                        lines.append(
                            f'{name}_bucket{{daemon="{daemon}",'
                            f'group="{group}",le="{le}"}} {cum}')
                    lines.append(
                        f'{name}_sum{labels} {val.get("sum", 0)}')
                    lines.append(
                        f'{name}_count{labels} {val.get("count", 0)}')
                    # precomputed tail gauges (p50/p95/p99/p999,
                    # bucket-interpolated): dashboards and alerts read
                    # these directly instead of re-deriving quantiles
                    # from _bucket series (docs/QOS.md)
                    for q, qlabel in LATENCY_QUANTILES:
                        est = quantile_from_cumulative(
                            val["buckets"], q)
                        if est is None:
                            continue
                        emit_type(f"{name}_{qlabel}", "gauge")
                        lines.append(
                            f"{name}_{qlabel}{labels} {est[0]:.9f}")
                elif isinstance(val, dict):   # time-avg
                    emit_type(f"{name}_sum", ctype)
                    emit_type(f"{name}_count", ctype)
                    lines.append(
                        f'ceph_tpu_{key}_sum{labels} {val.get("sum", 0)}')
                    lines.append(
                        f'ceph_tpu_{key}_count{labels} '
                        f'{val.get("avgcount", 0)}')
                else:
                    emit_type(name, ctype)
                    lines.append(f"{name}{labels} {val}")
        # per-pool PG state gauges from the control-plane ledger
        # (osd/pg_ledger.py): OSD daemons only — mons/others lack the
        # command, and a missing surface must not count as a scrape error
        if daemon.startswith("osd."):
            try:
                led = admin_command(path, {"prefix": "pg ledger"},
                                    timeout=2)
            except Exception:  # noqa: BLE001 - older daemon
                led = None
            counts = (led or {}).get("pg_state_counts")
            if isinstance(counts, dict):
                emit_type("ceph_tpu_pg_state", "gauge")
                for pool, states in sorted(counts.items()):
                    if not isinstance(states, dict):
                        continue
                    for state, n in sorted(states.items()):
                        lines.append(
                            f'ceph_tpu_pg_state{{daemon="{daemon}",'
                            f'pool="{pool}",state="{state}"}} {n}')
    return "\n".join(lines) + "\n"


def serve(asok_dir: str, port: int) -> None:
    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = collect(asok_dir).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", port), Handler)
    print(f"metrics on http://127.0.0.1:{httpd.server_port}/metrics",
          flush=True)
    httpd.serve_forever()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="metrics-exporter")
    ap.add_argument("--asok-dir", required=True)
    ap.add_argument("--port", type=int, default=9283)
    ap.add_argument("--once", action="store_true",
                    help="print one scrape to stdout and exit")
    args = ap.parse_args(argv)
    if args.once:
        sys.stdout.write(collect(args.asok_dir))
        return 0
    serve(args.asok_dir, args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
