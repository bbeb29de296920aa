"""Drive the port (ceph_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and PyTorch built for
CUDA; exits non-zero, printing no result, without them.  Builds the
CUDA kernels from ceph_tpu_torch/csrc/ (first use), then:

1. Kernels.  At the main paths' shapes, every kernel entry runs on the
   card against its plain PyTorch version on the same inputs; results
   must be equal exactly (bytes and crc values).  Each entry is timed
   with CUDA events: `ms` is the median of 25 event pairs, each around
   one replay of a CUDA graph of 10 calls (after 3 warm-up calls), per
   call — the kernel without the host's launch overhead, its inputs
   resident in L2; `single_ms` the median of 25 event pairs around one
   call queued behind a spin of the card that covers the host's launch
   (the kernel plus one launch's device-side gap); `cold_ms` the same
   after a 1 GiB read that evicts the 50 MB L2, so inputs come from
   device memory (cold_ms - single_ms is what a cold L2 costs);
   `plain_ms` the median of 21 event pairs around one call of the plain
   version (its host launch gaps included).  The
   bound is the bytes it must move over the card's memory rate
   (3.35 TB/s, the H100 SXM data sheet) or its byte operations (one
   GF(2^8) multiply-add per coefficient and column, one crc table step
   per shard byte) over the int8 rate (1,979 TOP/s), whichever is
   larger.  No single PyTorch call
   computes these functions, so library_ms is null.  Fifteen rows:
   K1 (encode, decode, the device entry), K2's three entries (hier, w32
   flat, and the byte entry of Pallas #6 at 8+3 x 512 KiB), K2's narrow
   branch (the hier entry at 16 KiB sub-blocks, which no path here
   selects: its launches are counted over every phase and may be 0), K3
   (one run, two runs), K5 (the deep-scrub crc of the JAX package's
   jitted `_rows_l`: a 64 MiB chunk of 132 x 512 KiB rows, a chunk of
   mixed rows, and an edge chunk whose rows cross the warps' block
   ranges, with rows of one block and empty rows) and K4 (Pallas #7's
   counterpart: 8 x 512 KiB -> 3 at one pass, and the CLAY repair
   matrices of phase G, 64 x 176 over 32 objects' 8 KiB sub-chunks and
   81 x 270 over 32 x 6473 B at two passes).  Then the K3 table: K3 on one 512 KiB run at B = 1,
   2 and 4 KiB, with its L zero-fill and without, and K2's hier entry
   at the same block as the run's control; the zero-fill alone; the two
   K3 rows beside their times before K3's redesign.  Then the K2 table:
   K2's hier entry at those blocks with its grid, and K2's three rows,
   beside their times before K2's redesign, K3 as the control.
2. Main path at combine="xla".  The port's ECBackend +
   LocalShardBackend over MemStore, plugin `torch`, k=8 m=3 cauchy (the
   ISA-L default profile), stripe unit 4096 B, dispatch-ahead depth 2,
   its operating point pinned to the K2 + fold combine through an
   autotune cache file (CEPH_TPU_AUTOTUNE_CACHE, as an operator would).
   Writes: 32 objects of 4 MiB (RBD's default object size) in a
   pipeline() window, one drain per op (512 KiB runs per shard: the
   hier entry of K2, path hier_lsub); 16 objects of 64 KiB (the flat
   entry); one batch() drain mixing both sizes (the split path); 8
   partial 16 KiB overwrites (RMW pre-read + K1 plain encode).  Then
   every object is read back and compared byte for byte, every object
   is read degraded with shards 0 and 1 failing (rebuilt by K1
   decode), parity is held against a host GF(2^8) reference on one
   object, and every valid HashInfo crc against the host crc32c of the
   stored shard bytes.  Launch counters are zeroed before each phase
   (writes, degraded reads) and must be > 0 for every kernel after it.
   The host time of the big writes is split by the backend's stage
   timers, and a profiled window of 8 more writes gives the card's
   busy share.
3. Autotune sweep (phase A).  ops/autotune sweeps (wb, combine) with a
   fresh cache file: every candidate is validated bit-exactly, then
   timed; the table is printed.  A second plugin init must take the
   point from the cached row (keyed by card name, sm, torch version and
   KERNEL_GEN) with zero measurements.
4. Main path at combine="kernel" (phase B): as 2., with 64 objects of
   4 MiB and the point pinned to K3 (path hier_acc, the mixed batch
   hier_acc+w32_flat); every fused result must have an empty tail.
   Then 16 x 4 MiB writes at the point the sweep picked, and an
   interleaved A/B of 16 x 4 MiB writes per round at the two combines
   (xla, kernel, kernel, xla, xla, kernel), each on a fresh backend.
5. Benchmark (phase C): ceph_tpu_torch.tools.ec_benchmark.main with the
   reference's canonical invocation (-P k=8 -P m=3 -S 1048576 -i 1000),
   the same with --batch 32, -w decode -e 1, and -w decode -e 2 -E
   exhaustive (all 55 erasure pairs verified).  Launches are counted
   over the two encode invocations (the row of encode_chunks_device)
   and over the two decode invocations apart.
6. Byte branch (phase D): a fresh backend whose codec has _use_w32 =
   False — ceph_tpu's byte-layout write path: 16 x 4 MiB, 16 x 64 KiB
   and one mixed batch(), every drain one launch of K2's byte entry
   (path "bytes", counted as a fallback drain), the hier, flat and K3
   counters 0; then readback, degraded reads with shards 0 and 1 down,
   parity and HashInfo checks.  GB/s and stage times are printed.
7. w32_sweep (phase E): ceph_tpu_torch.tools.w32_sweep at full size
   (4 MiB a chunk), K1 and K4 over tiles of 64 KiB - 4 MiB of each row
   per block, every configuration exact before it is timed.  Then K1 at
   4 and 16 bytes of each row a thread and at k1_launch's pick (printed
   for each width), and K4 forced to 1, 2, 4 and 8 passes of the 8
   source rows, at their default grids over rows of 16 KiB - 4 MiB,
   checked and timed as the kernel rows are.
8. CLAY repair (phase G): for k=8 m=4 d=11 (BASELINE.json) and k=8
   m=3 d=10, 32 objects of 4 MiB encoded on the host; for every lost
   chunk (12 and 11) a ClayRepairPlan and one apply_batch over the 32
   objects' helper repair planes (one K4 launch), every rebuilt chunk
   equal to the lost chunk, the batch to K4's plain version on the card
   and one object a chunk to codec.repair on the host; launches, wall
   time and GB/s of rebuilt bytes.  Then K4 at the batch shape at 1x,
   2x and 4x its fewest passes.
9. Recovery storm (phase H): an OSD-loss storm through one per-host
   ECLaunchQueue.  torch k=8 m=3 (its point pinned to K3), four PGs
   whose backends share the queue, 64 objects a PG of 4 MiB (RBD) and
   then of 64 KiB (small S3 objects), written round-robin through the
   queue (K3, K2's flat entry); then one shard (3) and then shards
   {0, 9} of every object lost and recovered in steps of three objects
   a PG, every PG's recover_shards_submit before any
   recover_shards_finalize (the halves of recover_shards_batch): K1
   decodes through the queue, at most 64 KiB of columns a coalesced
   launch.  Then CLAY k=8 m=4 d=11, two PGs x 16 objects of 4 MiB, chunk
   2 lost and repaired from the repair planes of 11 helpers through the
   queue (K4).  Every rebuilt shard must equal the lost bytes and its
   crc32c the stored HashInfo's; it is pushed back with its recovery
   xattrs.  Launch counters are zeroed before each write and recovery
   and read after; each recovery must have launched its kernel, and the
   small-object storm must show a decode launch that coalesced PGs.
   Rebuilt GB/s, wall time, the queue's status (launches, submissions a
   launch, cross-PG launches) and the flight recorder's launches by
   kind are printed with the card's name and power limit.
10. Deep scrub (phase I): the reference's deep-scrub bench setting,
   torch k=8 m=3 at the pinned K3 point, objects of 8 MiB with a 16 KiB
   stripe unit (1 MiB shard rows), 64 MiB scrub chunks.  Four PGs of 16
   objects (704 MiB of shards) and a fifth PG, with a 1 KiB stripe
   unit, of 8 objects of 8 MiB + 777 B, whose shard rows end in a 1 KiB
   tail.  A deep scrub of the clean PGs must find nothing, with one K5
   launch a chunk (14), the whole blocks counted as device bytes and
   the tails as host bytes.  Then bytes flip in 8 shards of different
   objects (data and parity shards, one byte in a tail), and a scrub
   with repair must find each as crc_mismatch on its shard and rebuild
   it (K1) to its original bytes.  Then a scrub of the same PGs on the
   host crc32c (the native library), and the device path again.  Walls
   and verified GB/s of both paths, the K5 launches, the byte split and
   the repair's K1 launches are printed.
11. Boot (phase J): two fresh processes (`chip_smoke.py --boot-child
   off|on`), one after the other, each loading the kernel library the
   parent built: `boot()` — a CephContext, the kernel library cache
   (ops/compile_cache), with "on" the prewarm (ops/prewarm.run_once,
   its widths the storm's stage widths, every entry run: skipped must
   be 0), the mesh service when configured — then phase H's 4 MiB
   storm's first write and first recovery pass (4 PGs x 64 x 4 MiB,
   shard 3).  Each prints its prewarm status, the cache's status, the
   compile ledger's first-launch and steady submit seconds by kind, and
   each step's wall and share in launch submits.
12. Mesh (phase K), k=8 m=3, 4 MiB objects: (a) `boot()` with
   osd_ec_use_mesh and mesh_devices "1" (a 1x1 MeshService on the card)
   and an ECBackend through it: 32 writes (plain K1 on the mesh, the
   crc32c on the host), readback, parity and HashInfo checks, reads
   with shards 0 and 1 down, shard 3 of all 32 rebuilt in one mesh
   decode; ec_mesh_drains > 0, ec_mesh_errors 0, mesh_error unset.  (b)
   DistributedStripeCodec on 4x1 and 2x2 meshes that repeat the card:
   encode_flat of 8 x 4 MiB, decode_flat_batch of 32 objects missing
   {0, 9}, clay_repair_batch of k8m4d11's plan (64 x 176) over 32
   objects' random helper rows, each byte-equal to the single-card
   plane and launching S*D K1 (K4 for CLAY) applies.  (c) one
   torch.cuda.nccl.all_gather of a one-member list (the binding; a
   multi-card gather needs more cards).  GB/s of each, launches and the
   mesh's gather kind are printed.
13. The cluster (phase L), in a fresh process (`chip_smoke.py
   --cluster-child CACHE ASOK`) whose kernel library cache (a directory
   of the run's own, holding a copy of the library the parent built) is
   set before the library's first load: tools/vstart.Cluster with a mon
   and 13 OSD daemons on the loopback messenger, MemStore, auth none,
   every codec and the host launch queue on the card, the boot prewarm
   on.  Pool A is torch k=8 m=3 cauchy, stripe unit 4096 B, 16 PGs
   (ISA-L's canonical profile, its point pinned to K3); pool B CLAY
   k=8 m=4 d=11, 8 PGs (BASELINE.json).  Through RadosClient, 16 ops in
   flight: 16 x 4 MiB written to pool A, 16 partial 64 KiB overwrites
   (RMW), 8 x 4 MiB to pool B, every object read back; OSD 5 killed
   and marked down and every object read degraded; OSD 5 marked out
   (`osd out`) and the cluster waited to active+clean (recovery onto
   the remapped PGs: K1 decodes, K4 CLAY repairs); every object read
   again; `scrub` with deep through every OSD's admin socket (K5).
   Every read must equal what was written; every shard on every live
   OSD its HashInfo crc (or its chunk crc after an overwrite); the
   scrub 0 errors with device bytes > 0; `prewarm status` and `compile
   ledger` read through the admin socket without an error and the
   cache enabled and loaded, not built; every pool-A PG's primary
   ec_drain_submits > 0.  Launch counts are zeroed after boot and read
   per step and at the end: K1, K4, K5 and a fused entry (K3 or K2)
   must each have launched, and only kernels the rows held.  Client
   GB/s per step, recovery's wall and rebuilt bytes, deep-scrub GB/s,
   the launches by kernel and by kind, and the launch queue's status are
   printed with the card's name and power limit.
14. The process cluster (phase M): tools/proc_cluster.ProcCluster, a
   mon with a data dir and 12 OSD daemons, each its own process
   (tools/daemon_main --device cuda), every OSD on BlueStore (Ceph
   Octopus's default objectstore) in a data dir of the run's own, its
   codecs and host launch queue on the card, the boot prewarm on, the
   kernel library loaded from a cache directory holding the library
   the parent built (each daemon's `compile ledger` must show 0 builds
   and its prewarm no error), the K3 point inherited through the
   pinned autotune cache; heartbeats off, the run marking the killed
   OSD down itself.  The card's compute mode must be Default.  Pool M
   is torch k=8 m=3 cauchy, stripe unit 4096 B, 16 PGs.  Through
   RadosClient, 16 in flight: 64 x 4 MiB written, 16 partial 64 KiB
   overwrites (8 KiB shard writes: BlueStore's deferred path); right
   after, the OSD holding data shard 1 of the first overwritten object
   SIGKILLed and marked down; 16 x 4 MiB written while it is down;
   every object read degraded (K1); the OSD revived on its BlueStore
   (deferred writes and the kv WAL replayed at mount) and the cluster
   waited to active+clean on the mon's `pg stat` (the missed shards
   rebuilt by K1 decodes); every object read; every daemon SIGKILLed,
   the mon too, and restarted from its data dir to active+clean; every
   acked object read; a deep scrub through every OSD's admin socket
   (K5).  Every read must equal what was written; the scrub must find
   0 errors with device bytes > 0; after the run every shard in every
   OSD's BlueStore, mounted offline, must match its HashInfo or chunk
   crc.  Each daemon's launches are read through its `launch profile`
   after its boot and before it is killed: K1, K3 and K5 must each have
   launched in the daemons, and only kernels the rows held.  Client
   GB/s per step, each daemon's boot seconds, the SIGKILL-to-active+
   clean wall and the bytes rebuilt, the cold restart's boot and
   active+clean seconds, deep-scrub GB/s, bytes on disk per OSD and
   the launches by kernel are printed with the card's name and power
   limit.
15. The block service (phase N): a process cluster of its own laid out
   as phase M's (a mon and 12 OSD processes on BlueStore, the library
   from the run's cache dir with 0 builds, prewarm on, heartbeats off)
   and an EC pool `rbd` of torch k=8 m=3 (K3 pinned), 16 PGs, driven
   through the `rbd` and `rados` CLIs (tools/rbd_cli, tools/rados_cli,
   each a subprocess with `-m` the mon) at RBD's default order 22 (4 MiB
   objects), a RadosClient in the parent keeping the bytes expected:
   `rbd create` of a 256 MiB thin image and `rbd import` of a seeded 64
   MiB file; `rbd bench` at 4 MiB (16 whole-object writes, K3) and at
   4 KiB over 64 KiB (16 read-modify-writes, K1 encodes); `rbd snap
   create`, 16 writes of 64 KiB through the library (copy-on-write
   clones on the OSDs), `rbd export-diff` from the snapshot and up to
   it, `rbd export` of the image and of an image rebuilt from the
   diffs by `rbd import-diff`; `rbd clone` of the snapshot and 16
   writes of 4 KiB into the clone (each first write to a block a
   copyup); a 16 MiB striped object at libradosstriper's default layout
   read whole, in part, and its first piece through `rados get`; then
   the OSD of data shard 1 of the image's first object SIGKILLed and
   marked down, `rbd export` degraded (K1 decodes), the OSD revived to
   active+clean, `rbd export` again.  Every export and read must equal
   the bytes expected; K3 and K1 must have launched in the daemons, and
   only kernels the rows held.  Each step's wall, bytes and GB/s, `rbd
   bench`'s own MB/s and the launches by kernel are printed with the
   card's name and power limit.
16. The file service and the cluster tools (phase O): a process cluster
   of its own laid out as phase M's (a mon and 12 OSD processes on
   BlueStore, the library from the run's cache dir with 0 builds,
   prewarm on, heartbeats off), a CephFS whose data pool `cephfs_data`
   is torch k=8 m=3 (K3 pinned), 16 PGs, made before the MDS boots, at
   CephFS's default file layout (4 MiB blocks: the MDS's block_size),
   one MDS process (tools/daemon_main mds through
   ProcCluster.spawn_mds), and a mgr in the parent with the default
   modules and the dashboard, started before any file data: the
   balancer's moves must settle (at most 60 s).  A CephFS client in the
   parent (`fs_sequence`): /vol/d0-d3, 4 files of 16 MiB (16 whole
   blocks, K3) and 16 of 64 KiB; 16 overwrites of 64 KiB at 4 KiB
   aligned offsets (read-modify-writes, K1 encodes); a truncate to an
   unaligned size, a directory rename, 8 unlinks whose data objects
   must be purged; a snapshot of /vol and 16 overwrites under it (its
   view must keep the older bytes); a second client reads every
   directory and file; the OSD of data shard 1 of the first file's
   first block SIGKILLed and marked down (`ceph_cli health` must report
   HEALTH_WARN with PG_DEGRADED, the mgr's health module HEALTH_WARN),
   every big file read degraded (K1 decodes), the OSD revived to
   active+clean (`ceph_cli progress` must show the recovery at 1.0),
   read again; the MDS SIGKILLed and spawned again under its name, a
   fresh client seeing the namespace, every file and the snapshot.
   Then the tools against the cluster: `ceph_cli status`, `osd tree`,
   `pg stat`, `ceph_cli daemon` osd.0's `launch profile` (equal to
   its admin socket's), metrics_exporter.collect (every daemon up, the
   launch-latency gauges), the dashboard's /api/health (the mgr's
   status).  Then tools/cluster_bench --quick --mesh at 4 MiB for 1 s a
   row on the card (thread topology, 12 OSDs on MemStore): every row
   must write and read, the mesh row must name its mesh and launch K1.
   Every read must equal the bytes written; K3 and K1 must have
   launched in the daemons, and only kernels the rows held (cluster_
   bench's too).  Each step's wall, bytes, GB/s or op/s, the tools'
   waits, cluster_bench's rows and the launches by kernel are printed
   with the card's name and power limit.
17. The object service (phase P): a process cluster of its own laid
   out as phase M's, RGW with `.rgw.data` of torch k=8 m=3 (K3 pinned),
   16 PGs, made before any gateway starts, and `.rgw.meta` replicated;
   the gateway a process (`python -m ceph_tpu_torch.rgw.gateway --port
   0 --ec-profile rgw_k8m3` with SigV4 credentials), a second zone an
   in-process cluster of 12 OSDs on the card with its own torch k=8 m=3
   `.rgw.data` (`object_sequence`, through an S3 client signing with
   the port's sigv4): buckets b0-b3, 16 objects of 4 MiB PUT from 8
   client threads (K3; each ETag the body's md5), 16 of 64 KiB (K2
   flat), two multipart uploads of 4 x 5 MiB parts (the ETag's
   md5-of-md5s form, a whole GET, a ranged read of a part) and a
   server-side copy; versioning on b1 (two versions read back by id, a
   delete marker, GET 404, the versions still readable); a lifecycle
   rule expiring tmp/ on b2, swept by a store in the parent two days
   on (objects and data objects gone); every bucket listed with a
   delimiter and flat in pages of 7, b3 resharded 1 -> 8 index shards
   and listed again through the gateway and a store in the parent;
   Swift (a token, a container, a 4 MiB object read through S3, an S3
   object through Swift); the OSD of data shard 1 of the first object
   SIGKILLed, every 4 MiB and multipart object read from 8 threads (K1
   decodes), revived to active+clean, read again; the gateway
   SIGKILLed and started again, every bucket, listing, version and
   object read back; a store with a mod-log in the parent: a topic to a
   local HTTP receiver bound on a new bucket n0, a full sync to the
   second zone, 8 x 4 MiB into n0, an incremental sync, every event
   received and the zones equal.  Then the `rgw` role of daemon_main
   (ProcCluster.spawn_rgw) serves a bucket, an object and a GET.  K3,
   K2 flat and K1 must have launched in the daemons and K3 in the
   second zone, only kernels the rows held; a 5xx answer or a gateway
   exit fails the phase.  Each step's wall, bytes, GB/s or op/s and the
   launches by kernel (daemons and second zone) are printed with the
   card's name and power limit.
18. The load harness and the deployer (phase Q): tools/load_harness.py
   and tools/deploy.py through their entry points.  Q1: `python -m
   ceph_tpu_torch.tools.load_harness --scenario qos-sim` and
   `qos-sim-recovery` (the mClock sims in virtual time) must exit 0
   with the victim isolated.  Q2: run_ec_pg_sweep in this process, as
   bench.py calls it: 128 objects of 4 MiB over 1, 8 and 64 PGs of torch
   k=8 m=3 (K3 pinned, stripe unit 4096 B) that share one launch queue,
   one pass; every object acked, a launch that coalesced PGs and more
   than one run a launch (the fraction of the one-PG rate is printed
   beside the reference's 0.8, not gated).  Q3: run_degraded_read_storm
   (12 OSDs, 16 x 4 MiB, one kill/revive cycle, 3 timed read passes)
   in a child process (`chip_smoke.py --harness-child storm CACHE`):
   `ok`, zero acked loss, no mismatch, a reconstructed read.  Q4, in a
   child (`--harness-child mixed CACHE`): a 12-OSD cluster with a torch
   k=8 m=3 pool of 16 PGs and `.rgw.data` of the same profile made
   before the gateway starts; run_rados_mixed closed-loop (16 clients,
   64 Zipf-hot objects of 4 MiB, half reads, 5 s) and open-loop (8
   workers x 25 sessions at 10/s, 4x bursts on 5 ops of every 20, 64
   KiB objects, 5 s), run_s3_mixed (8 clients, 32 objects of 4 MiB, 5
   s), run_rbd_mixed on a replicated pool (4 clients, 3 s): every row
   0 errors and some ops.  Q5: `python -m ceph_tpu_torch.tools.deploy
   apply` of the deployer's example spec on BlueStore (a mon, 12 OSDs,
   an MDS and a gateway, booted one at a time, codecs on the card, the
   library from the run's cache directory); `ls` shows the 15 units
   running; a torch k=8 m=3 pool of 16 PGs made through the mon of
   monmap.json, 16 x 4 MiB written, `stop` of the OSD of data shard 1
   of the first object, every object read degraded, 4 MiB PUT and GET
   through rgw.0, `start` of the OSD to active+clean, every object read
   again; `rm-cluster` leaves no live pid and no directory.  Deployed
   daemons serve no admin socket, so Q5 counts no launches: its reads,
   equal to the bytes written, and its units' `--device cuda` show the
   work.  Q5 runs beside Q3 and Q4 (its daemons boot one at a time,
   about two minutes on the card).  K3, K2 flat and K1 must have
   launched over Q2-Q4 (Q3's and Q4's counted in their children), only
   kernels the rows held.  Each
   sub-phase's wall, Q2's GB/s by PG count, runs a launch and occupancy,
   Q3's read percentiles, degraded-window ledger and device stages,
   Q4's rows' percentiles and Q5's steps are printed with the card's
   name and power limit.
19. A/B (phase F): the native CPU library must have built; then
   ec_benchmark --ab (isa against torch, 1 MiB objects, per call and
   --batch 32, 1 s a side and mode) and -p isa / -p jerasure with the
   canonical invocation.

Output: the card's name and power limit, the sweep tables, the kernels,
K3 table and K2 table JSON lines (each kernel row with its launches on
its own phase, in the recovery storm, in phase K, in phase L, in
phase M's, phase N's and phase O's daemons, in phase P's daemons
and second zone and in phase Q), the
main paths', the benchmark's, the w32 sweep's, the CLAY repair's, the
recovery storm's, the deep scrub's, the boot's, the mesh's, the
cluster's, the process cluster's, the block service's, the A/B's and
the file service's (with cluster_bench's rows), the object
service's and the harness's lines,
and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
(the script drives one card).  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (data sheet)
INT8_OPS_PER_S = 1.979e15       # H100 SXM int8 tensor rate (data sheet)
K, M = 8, 3
STRIPE_UNIT = 4096
BIG = 4 << 20                   # 4 MiB objects
SMALL = 64 << 10                # 64 KiB objects
N_BIG_XLA, N_BIG_ACC, N_BIG_PICK, N_BIG_BYTES = 32, 64, 16, 16
N_SMALL, N_RMW = 16, 8
RMW_LEN = 16 << 10
SEED = 20261016
# CLAY profiles of phase G: BASELINE.json's k=8 m=4 d=11 and the k=8 m=3
# d=10 geometry of the ISA-L default profile's (k, m)
CLAY_PROFILES = {"k8m4d11": (8, 4, 11), "k8m3d10": (8, 3, 10)}
N_CLAY_OBJECTS = 32
SPIN_CYCLES = 1_000_000         # ~0.5 ms of card clock


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def device_events(fn):
    """Run fn under torch.profiler; returns [(name, device us)] of every
    activity that ran on the card (kernels and copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def event_ms(fn, warmup: int = 1, iters: int = 21) -> float:
    """Median milliseconds of one call of `fn` between a pair of CUDA
    events (the host's launch gaps inside the call included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def single_event_ms(fn, flush: torch.Tensor | None = None,
                    iters: int = 25) -> float:
    """Median milliseconds of one call of `fn` queued behind a spin of
    the card that lasts longer than the host's launch of the call; with
    `flush` (larger than L2) read first, its inputs come from device
    memory."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_event_ms(fn) -> float:
    """Median over 25 CUDA-event pairs, each around one replay of a CUDA
    graph holding 10 back-to-back calls of `fn`, per call: the kernel's
    time without the host's launch overhead (w32_sweep's timer)."""
    from ceph_tpu_torch.tools.w32_sweep import graph_ms
    return graph_ms(fn, calls=10, samples=25)


class StageTimes:
    """The ECBackend perf hook: accumulates its stage timers and counters
    (inc/set/tinc) so the run can say where the host time goes."""

    def __init__(self):
        self.t: dict[str, float] = {}
        self.n: dict[str, int] = {}

    def inc(self, key, by=1):
        self.n[key] = self.n.get(key, 0) + by

    def set(self, key, value):
        self.n[key] = value

    def tinc(self, key, dt):
        self.t[key] = self.t.get(key, 0.0) + dt


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0




def kernel_row(name, src, replaces, counter, phase, kern, plain, shapes,
               nbytes, ops, flush) -> dict:
    """Check one kernel entry against its plain version (exact, and the
    expected output shapes) and time both; `phase` names the main-path
    phase whose launch count the row reports."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    shapes_ok = len(got) == len(want) == len(shapes) and all(
        tuple(g.shape) == tuple(w.shape) == sh
        for g, w, sh in zip(got, want, shapes))
    if err != 0 or not shapes_ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err}, shapes "
                             f"{[tuple(g.shape) for g in got]})")
    bound_ms, bound_by = bound(nbytes, ops)
    return {"name": name, "route": "cuda",
            "source": f"ceph_tpu_torch/{src}", "replaces": replaces,
            "counter": counter, "phase": phase, "launches": None,
            "max_abs_err": err, "ms": graph_event_ms(kern),
            "single_ms": single_event_ms(kern),
            "cold_ms": single_event_ms(kern, flush),
            "plain_ms": event_ms(plain), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_kernels(dev, bs, gf, rng, codec) -> list[dict]:
    """Every kernel entry against its plain version at the main paths'
    shapes; exact equality required."""
    gen = gf.cauchy_rs_matrix(K, M)
    enc = bs.tables_tensor(gf.product_tables(gen[K:]), dev)
    lost = (0, 1)
    survivors = tuple(s for s in range(K + M) if s not in lost)[:K]
    dec = bs.tables_tensor(gf.product_tables(
        gf.recovery_matrix(gen, K, survivors, lost)), dev)
    run = BIG // K                                 # 512 KiB per shard
    small = 8 << 10                                # 8 KiB per shard
    bench = (1 << 20) // K                         # 1 MiB object: 128 KiB
    block = 4 * bs.FUSED_WB

    def rand(n):
        return torch.from_numpy(
            rng.integers(0, 256, (K, n), dtype=np.uint8)).to(dev)
    data, data_small, data_bench = rand(run), rand(small), rand(bench)
    # K3's two-run case: a 512 KiB run, then one of odd width front-padded
    # to the block, as the extents path lays them out
    odd = 300 * 1024 + 777
    pad = -odd % block
    data_two = torch.cat([data, torch.zeros((K, pad), dtype=torch.uint8,
                                            device=dev), rand(odd)], dim=1)
    blocks_two = [run // block, (odd + pad) // block]
    staged_one, ends_one = bs._acc_launch_args([run // block], dev)
    staged_two, ends_two = bs._acc_launch_args(blocks_two, dev)
    torch.cuda.synchronize()
    del staged_one, staged_two

    def gf_bytes(r, n):
        return K * n + r * n + r * K * 256

    def gf_ops(r, n):
        return 2 * r * K * n                 # GF(2^8) multiply-adds

    def crc_ops(n):
        return 2 * (K + M) * n               # one crc table step a byte

    n_two = data_two.shape[1]
    flush = torch.zeros(1 << 28, dtype=torch.int32, device=dev)  # 1 GiB
    rows = [
        kernel_row("gf_bitmatmul (encode, K1)", "csrc/gf_bitmatmul.cu",
                   "ceph_tpu/ops/bitsliced.py:227", "gf_bitmatmul",
                   "xla_write",
                   lambda: bs.gf_bitmatmul(enc, data),
                   lambda: bs.gf_bitmatmul_plain(enc, data), [(M, run)],
                   gf_bytes(M, run), gf_ops(M, run), flush),
        kernel_row("gf_bitmatmul (decode, K1)", "csrc/gf_bitmatmul.cu",
                   "ceph_tpu/ops/bitsliced.py:227", "gf_bitmatmul",
                   "xla_read",
                   lambda: bs.gf_bitmatmul(dec, data),
                   lambda: bs.gf_bitmatmul_plain(dec, data),
                   [(len(lost), run)], gf_bytes(len(lost), run),
                   gf_ops(len(lost), run), flush),
        kernel_row("fused_hier_call (K2, 2 KiB sub-blocks)",
                   "csrc/gf_encode_crc_acc.cu",
                   "ceph_tpu/ops/bitsliced.py:523",
                   "fused_hier_call", "xla_write",
                   lambda: bs.fused_hier_call(enc, data, bs.FUSED_WB),
                   lambda: bs.fused_hier_call_plain(enc, data, bs.FUSED_WB),
                   [(M, run), (K + M, run // block)],
                   gf_bytes(M, run) + (K + M) * (run // block) * 4,
                   gf_ops(M, run) + crc_ops(run), flush),
        kernel_row("gf_encode_with_crc_w32 (K2, 2 KiB tiles)",
                   "csrc/gf_encode_crc_acc.cu",
                   "ceph_tpu/ops/bitsliced.py:437",
                   "gf_encode_with_crc_w32", "xla_write",
                   lambda: bs.gf_encode_with_crc_w32(enc, data_small,
                                                     bs.FUSED_TILE),
                   lambda: bs.gf_encode_with_crc_w32_plain(enc, data_small,
                                                           bs.FUSED_TILE),
                   [(M, small), (K + M, small // bs.FUSED_TILE)],
                   gf_bytes(M, small) + (K + M) * (small // bs.FUSED_TILE) * 4,
                   gf_ops(M, small) + crc_ops(small), flush),
        kernel_row("gf_encode_crc_acc (K3, one 512 KiB run)",
                   "csrc/gf_encode_crc_acc.cu",
                   "ceph_tpu/ops/bitsliced.py:539", "fused_hier_acc_call",
                   "kernel_write",
                   lambda: bs.fused_hier_acc_call(enc, data, ends_one,
                                                  bs.FUSED_WB),
                   lambda: bs.fused_hier_acc_call_plain(enc, data, ends_one,
                                                        bs.FUSED_WB),
                   [(M, run), (1, K + M)],
                   gf_bytes(M, run) + (K + M) * 4 + 8,
                   gf_ops(M, run) + crc_ops(run), flush),
        kernel_row("gf_encode_crc_acc (K3, 2 runs, one odd-width)",
                   "csrc/gf_encode_crc_acc.cu",
                   "ceph_tpu/ops/bitsliced.py:539", "fused_hier_acc_call",
                   "kernel_write",
                   lambda: bs.fused_hier_acc_call(enc, data_two, ends_two,
                                                  bs.FUSED_WB),
                   lambda: bs.fused_hier_acc_call_plain(enc, data_two,
                                                        ends_two,
                                                        bs.FUSED_WB),
                   [(M, n_two), (2, K + M)],
                   gf_bytes(M, n_two) + 2 * (K + M) * 4 + 16,
                   gf_ops(M, n_two) + crc_ops(n_two), flush),
        kernel_row("encode_chunks_device (K1, 8 x 128 KiB)",
                   "csrc/gf_bitmatmul.cu", "ceph_tpu/ops/bitsliced.py:122",
                   "gf_bitmatmul", "bench_encode",
                   lambda: codec.encode_chunks_device(data_bench),
                   lambda: bs.gf_bitmatmul_plain(codec._enc_tables,
                                                 data_bench),
                   [(M, bench)], gf_bytes(M, bench), gf_ops(M, bench),
                   flush),
        kernel_row("gf_encode_with_crc (K2 byte entry, 2 KiB tiles)",
                   "csrc/gf_encode_crc_acc.cu",
                   "ceph_tpu/ops/bitsliced.py:385",
                   "gf_encode_with_crc", "bytes_write",
                   lambda: bs.gf_encode_with_crc(enc, data, bs.FUSED_TILE),
                   lambda: bs.gf_encode_with_crc_plain(enc, data,
                                                       bs.FUSED_TILE),
                   [(M, run), (K + M, run // bs.FUSED_TILE)],
                   gf_bytes(M, run) + (K + M) * (run // bs.FUSED_TILE) * 4,
                   gf_ops(M, run) + crc_ops(run), flush),
        kernel_row("gf_bitmatmul_stream (K4, 8 x 512 KiB -> 3)",
                   "csrc/gf_bitmatmul_stream.cu",
                   "ceph_tpu/ops/bitsliced.py:245", "gf_bitmatmul_stream",
                   "w32_sweep",
                   lambda: bs.gf_bitmatmul_stream(enc, data),
                   lambda: bs.gf_bitmatmul_stream_plain(enc, data),
                   [(M, run)], gf_bytes(M, run), gf_ops(M, run), flush),
    ]
    # K2's narrow branch (one shared crc table, the operators from their
    # columns), which 8+3 takes at 16 KiB sub-blocks: no path of this
    # script selects it, so its launches (bs._encode_crc_launch's
    # narrow count over every phase) are expected to be 0
    narrow_wb = 4096
    if bs.k2_lane_tables(M, K, 4 * narrow_wb):
        raise AssertionError("8+3 at 16 KiB no longer takes K2's narrow "
                             "branch")
    nb = 4 * narrow_wb
    rows.append(kernel_row(
        "fused_hier_call (K2 narrow branch, 16 KiB sub-blocks)",
        "csrc/gf_encode_crc_acc.cu", "ceph_tpu/ops/bitsliced.py:523",
        None, None,
        lambda: bs.fused_hier_call(enc, data, narrow_wb),
        lambda: bs.fused_hier_call_plain(enc, data, narrow_wb),
        [(M, run), (K + M, run // nb)],
        gf_bytes(M, run) + (K + M) * (run // nb) * 4,
        gf_ops(M, run) + crc_ops(run), flush))
    # K5 at a 64 MiB scrub chunk of 4 MiB objects (132 rows of 512 KiB),
    # at a chunk of mixed rows: 66 of 1 MiB (phase I's), 11 of 600 KiB,
    # 11 of one block and 3 empty, and at an edge chunk whose rows cross
    # the warps' block ranges, with rows of one block and empty rows
    # (tools/k3_phases.K5_SHAPES)
    from ceph_tpu_torch.tools.k3_phases import K5_SHAPES
    for label, counts in (
            ("132 x 512 KiB", K5_SHAPES["chunk"]),
            ("mixed: 66 x 1 MiB, 11 x 600 KiB, 11 x 2 KiB, 3 empty",
             K5_SHAPES["mixed"]),
            ("edge: 64 x (1, 0, 7, 1, 0, 0, 13, 1 blocks) + 4099 blocks",
             K5_SHAPES["edge"])):
        n = sum(counts) * 2048
        body = torch.from_numpy(np.frombuffer(rng.bytes(n), dtype=np.uint8)
                                .copy()).to(dev)
        ends = torch.tensor(np.cumsum(counts), dtype=torch.int64,
                            device=dev)
        rows.append(kernel_row(
            f"crc32c_rows (K5, {label})", "csrc/gf_encode_crc_acc.cu",
            "ceph_tpu/ops/crc32c_linear.py:189", "crc32c_rows_l",
            "deep_scrub",
            lambda b=body, e=ends: bs.crc32c_rows_l(b, e),
            lambda b=body, e=ends: bs.crc32c_rows_l_plain(b, e),
            [(len(counts),)], n + 16 * len(counts), n, flush))
    for name, (ck, cm, cd) in CLAY_PROFILES.items():
        codec_c = clay_codec(ck, cm, cd)
        mat = codec_c.repair_matrix(0)
        r, j = mat.shape
        n = N_CLAY_OBJECTS * clay_sub_size(codec_c)
        tab = bs.tables_tensor(gf.product_tables(mat), dev)
        rows_c = torch.from_numpy(
            rng.integers(0, 256, (j, n), dtype=np.uint8)).to(dev)
        passes = bs.k4_plan(r, j, n, torch.cuda.get_device_properties(
            dev).multi_processor_count).passes
        rows.append(kernel_row(
            f"gf_bitmatmul_stream (K4, CLAY {name}: {r} x {j} over "
            f"{N_CLAY_OBJECTS} x {n // N_CLAY_OBJECTS} B, {passes} "
            f"pass{'es' if passes > 1 else ''})",
            "csrc/gf_bitmatmul_stream.cu", "ceph_tpu/ops/bitsliced.py:245",
            "gf_bitmatmul_stream", "clay_repair",
            lambda tab=tab, x=rows_c: bs.gf_bitmatmul_stream(tab, x),
            lambda tab=tab, x=rows_c: bs.gf_bitmatmul_stream_plain(tab, x),
            [(r, n)], j * n + r * n + r * j * 256, 2 * r * j * n, flush))
    del flush
    return rows


def clay_codec(k: int, m: int, d: int):
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    return ErasureCodePluginRegistry.instance().factory(
        "clay", {"k": str(k), "m": str(m), "d": str(d)})


def clay_sub_size(codec) -> int:
    """Bytes a sub-chunk of a 4 MiB object: 8192 at k=8 m=4 d=11, 6473
    at k=8 m=3 d=10 (its chunk aligned to 81 sub-chunks)."""
    return codec.get_chunk_size(BIG) // codec.get_sub_chunk_count()


def phase_clay_repair(dev, rng) -> tuple[dict, dict]:
    """Phase G: CLAY single-chunk repair on the card.  For each CLAY
    profile of BASELINE.json's configs and k=8 m=3 d=10, 32 objects of
    4 MiB are encoded on the host; for every lost chunk a ClayRepairPlan
    is built and one apply_batch (one K4 launch) rebuilds the chunk of
    all 32 objects from their helpers' repair planes.  Every rebuilt
    chunk must equal the object's lost chunk, the batch K4's plain
    version on the card, and one object a lost chunk codec.repair on the
    host.  Returns (launch counts of the repairs, the report).  Then K4
    at each profile's batch shape at more passes than it needs (the
    multi-pass path at these shapes), checked and timed as the kernel
    rows are."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.parallel import ClayRepairPlan

    report = {}
    counts = {}
    for name, (ck, cm, cd) in CLAY_PROFILES.items():
        codec = clay_codec(ck, cm, cd)
        n_chunks = ck + cm
        sub = codec.get_sub_chunk_count()
        s = clay_sub_size(codec)
        t0 = time.perf_counter()
        encs = [codec.encode(set(range(n_chunks)), rng.bytes(BIG))
                for _ in range(N_CLAY_OBJECTS)]
        t_encode = time.perf_counter() - t0
        if len(encs[0][0]) != sub * s:
            raise AssertionError(f"{name}: chunk of {len(encs[0][0])} B")
        plans, batches = [], []
        for lost in range(n_chunks):
            plan = ClayRepairPlan.build(codec, lost, device=dev)
            planes = codec.repair_planes(lost)
            batches.append([codec.repair_rows(lost, {
                ch: np.asarray(e[ch]).reshape(sub, s)[planes]
                for ch in plan.helper_ids}) for e in encs])
            plan.tables_tensor()
            plans.append(plan)
        torch.cuda.synchronize()
        bs.reset_launch_counts()
        per_chunk_s = []
        outs = []
        for plan, batch in zip(plans, batches):
            t0 = time.perf_counter()
            outs.append(plan.apply_batch(batch))
            per_chunk_s.append(time.perf_counter() - t0)
        counts[name] = bs.launch_counts()
        if counts[name]["gf_bitmatmul_stream"] != n_chunks:
            raise AssertionError(f"{name}: {counts[name]} launches for "
                                 f"{n_chunks} batches")
        for lost, (plan, batch, out) in enumerate(zip(plans, batches, outs)):
            for i, e in enumerate(encs):
                if not np.array_equal(out[i].reshape(-1), e[lost]):
                    raise AssertionError(f"{name}: chunk {lost} of object "
                                         f"{i} rebuilt wrong")
            i = lost % N_CLAY_OBJECTS
            planes = codec.repair_planes(lost)
            host = codec.repair(lost, {
                ch: np.asarray(encs[i][ch]).reshape(sub, s)[planes]
                for ch in plan.helper_ids}, s)
            if not np.array_equal(out[i].reshape(-1), host):
                raise AssertionError(f"{name}: chunk {lost} of object {i} "
                                     "differs from codec.repair")
            big = torch.from_numpy(np.concatenate(batch, axis=1)).to(dev)
            plain = bs.gf_bitmatmul_stream_plain(plan.tables_tensor(), big)
            if not np.array_equal(np.concatenate(out, axis=1),
                                  plain.cpu().numpy()):
                raise AssertionError(f"{name}: chunk {lost} batch differs "
                                     "from K4's plain version")
        rebuilt = n_chunks * N_CLAY_OBJECTS * sub * s
        wall = sum(per_chunk_s)
        report[name] = {
            "profile": {"k": ck, "m": cm, "d": cd},
            "matrix": [plans[0].out_rows, plans[0].in_rows],
            "sub_chunk_bytes": s, "objects": N_CLAY_OBJECTS,
            "lost_chunks": n_chunks,
            "launches": counts[name]["gf_bitmatmul_stream"],
            "encode_s": t_encode, "repair_wall_s": wall,
            "per_chunk_s": per_chunk_s, "rebuilt_bytes": rebuilt,
            "rebuilt_GBps": rebuilt / wall / 1e9,
            "host_checked_objects": n_chunks}
        print(f"# clay_repair {name} {plans[0].out_rows} x "
              f"{plans[0].in_rows}: {n_chunks} lost chunks x "
              f"{N_CLAY_OBJECTS} objects, {wall:.4f} s, "
              f"{rebuilt / wall / 1e9:.3f} GB/s rebuilt", flush=True)
        # K4 at the batch's shape at more passes than it needs
        plan = plans[0]
        big = torch.from_numpy(np.concatenate(batches[0], axis=1)).to(dev)
        tab = plan.tables_tensor()
        want = bs.gf_bitmatmul_stream_plain(tab, big)
        fewest = bs.stream_groups(plan.in_rows)
        passes_table = []
        for p in sorted({fewest, 2 * fewest, 4 * fewest}):
            def fn(p=p):
                return bs.gf_bitmatmul_stream(tab, big, groups=p)
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name}: K4 at {p} passes differs")
            us = graph_event_ms(fn) * 1e3
            passes_table.append({"passes": p, "us": us})
            print(f"# k4_clay_passes {name} passes={p}  {us:9.3f} us",
                  flush=True)
        report[name]["k4_passes"] = passes_table
    merged = {}
    for c in counts.values():
        for key, v in c.items():
            merged[key] = merged.get(key, 0) + v
    return merged, report


# Phase H: the recovery storm.  torch k=8 m=3 over N_STORM_PGS PGs
# sharing one ECLaunchQueue, N_STORM_OBJECTS objects a PG of each size;
# CLAY k=8 m=4 d=11 over 2 PGs of 16 objects of 4 MiB
N_STORM_PGS, N_STORM_OBJECTS = 4, 64
STORM_LOSSES = ((3,), (0, 9))
N_CLAY_STORM_PGS, N_CLAY_STORM_OBJECTS = 2, 16
CLAY_STORM_LOST = 2
# objects a PG recovers at a time (the reference's osd_recovery_max_active
# default for an HDD OSD); every PG's step is submitted before any is
# finalized, as an OSD recovering several PGs at once
STORM_STEP = 3
# the storm's queue window: each step is finalized right after it is
# submitted, so the window only has to outlast a step's submit half (a
# 250 us window fires inside it and launches the first PGs' decodes alone)
STORM_WINDOW_US = 20_000.0


def storm_pgs(dev, queue, plugin: str, profile: dict, n_pgs: int, store):
    """n_pgs ECBackends of one pool (pg_t(2, i)), each with its own codec
    instance, over one MemStore, all submitting to `queue`."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import pg_t
    out = []
    for i in range(n_pgs):
        codec = ErasureCodePluginRegistry.instance().factory(
            plugin, dict(profile))
        k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
        chunk = codec.get_chunk_size(k * STRIPE_UNIT)
        shards = LocalShardBackend(store, pg_t(2, i), n)
        out.append(ECBackend(codec, StripeInfo(k * chunk, chunk), shards,
                             launch_queue=queue, device=dev))
    return out


def storm_write(backends, rng, size: int, n_objects: int) -> dict:
    """n_objects objects of `size` bytes a PG, submitted round-robin over
    the PGs inside one pipeline() window each, so drains of different PGs
    meet in the queue.  Returns {(pg index, name): payload}."""
    from ceph_tpu_torch.osd.ec_transaction import PGTransaction
    from ceph_tpu_torch.osd.types import eversion_t, hobject_t
    objs = {(p, f"o{i}"): np.frombuffer(rng.bytes(size), dtype=np.uint8)
            for i in range(n_objects) for p in range(len(backends))}
    acks = []
    with contextlib.ExitStack() as stack:
        for be in backends:
            stack.enter_context(be.pipeline())
        for v, ((p, name), data) in enumerate(objs.items()):
            txn = PGTransaction()
            txn.write(hobject_t(pool=2, name=name), 0, data)
            backends[p].submit_transaction(
                txn, eversion_t(1, v + 1), lambda: acks.append(1))
    if len(acks) != len(objs):
        raise AssertionError(f"{len(acks)} of {len(objs)} writes acked")
    return objs


def storm_recover(backends, objs, missing, step: int = STORM_STEP,
                  pool: int = 2) -> dict:
    """Lose `missing` shards of every object (of `pool`), then recover
    them in steps of `step` objects a PG: every PG's
    recover_shards_submit before any recover_shards_finalize (the two
    halves of recover_shards_batch),
    as an OSD recovering several PGs at once; each rebuilt shard is pushed back
    to its collection with its recovery xattrs.  Every rebuilt shard must
    equal the lost bytes and its crc32c the stored HashInfo's.  Returns
    the rebuilt bytes and the wall seconds."""
    from ceph_tpu_torch.common import crc32c
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_transaction import shard_oid
    from ceph_tpu_torch.osd.types import hobject_t
    from ceph_tpu_torch.store.object_store import Transaction
    lost = {}
    for (p, name) in objs:
        sh = backends[p].shards
        o = hobject_t(pool=pool, name=name)
        for s in missing:
            g = shard_oid(o, s)
            lost[(p, name, s)] = sh.store.read(sh.cids[s], g).copy()
            t = Transaction()
            t.remove(g)
            sh.store.queue_transactions(sh.cids[s], [t])
    pushed = {}

    def push_for(p, name):
        sh = backends[p].shards

        def push(s, data, hinfo):
            g = shard_oid(hobject_t(pool=pool, name=name), s)
            t = Transaction()
            t.write(g, 0, data)
            t.setattrs(g, ec_util.recovery_attrs(hinfo, data))
            sh.store.queue_transactions(sh.cids[s], [t])
            pushed[(p, name, s)] = (data, hinfo)
        return push

    items = [[(hobject_t(pool=pool, name=name), list(missing))
              for (q, name) in objs if q == p] for p in range(len(backends))]
    t0 = time.perf_counter()
    results = {}
    for lo in range(0, max(map(len, items)), step):
        recs = [be.recover_shards_submit(
            its[lo:lo + step], lambda o, p=p: push_for(p, o.name))
            for p, (be, its) in enumerate(zip(backends, items))]
        for p, (be, rec) in enumerate(zip(backends, recs)):
            for o, err in be.recover_shards_finalize(rec).items():
                results[(p, o.name)] = err
    wall = time.perf_counter() - t0
    bad = {key: err for key, err in results.items() if err is not None}
    if bad or len(results) != len(objs):
        raise AssertionError(f"recovery failed for {len(bad)} objects "
                             f"({len(results)} of {len(objs)} answered): "
                             f"{next(iter(bad.values()), None)!r}")
    nbytes = 0
    for key, want in lost.items():
        data, hinfo = pushed[key]
        if not np.array_equal(data, want):
            raise AssertionError(f"rebuilt shard {key} differs")
        if not hinfo.crc_valid or crc32c.crc32c(data.tobytes()) != \
                hinfo.get_chunk_hash(key[2]):
            raise AssertionError(f"rebuilt shard {key}: crc32c differs "
                                 "from its HashInfo")
        nbytes += data.size
    return {"rebuilt_bytes": nbytes, "wall_s": wall,
            "rebuilt_GBps": nbytes / wall / 1e9}


def storm_snapshot(queue, prof) -> tuple[dict, dict]:
    return queue.status(), prof.perf.dump()


def storm_counts(bs, queue, prof, before) -> dict:
    """Kernel launches, queue status and flight-recorder launches by kind
    since `before` (storm_snapshot), with the seconds the recorded
    launches spent in their submit (for a decode or a repair: staging,
    the kernel and the copy back) and in materialize."""
    before, lat0 = before
    st = queue.status()
    lat = prof.perf.dump()
    launches = st["launches"] - before["launches"]
    return {"kernel_launches": bs.launch_counts(),
            "launch_submit_s": lat["lat_launch_submit"]["sum"]
            - lat0["lat_launch_submit"]["sum"],
            "launch_materialize_s": lat["lat_launch_device"]["sum"]
            - lat0["lat_launch_device"]["sum"],
            "queue_launches": launches,
            "decode_launches": st["decode_launches"]
            - before["decode_launches"],
            "repair_launches": st["repair_launches"]
            - before["repair_launches"],
            "cross_pg_launches": st["cross_pg_launches"]
            - before["cross_pg_launches"],
            "subs_per_launch": (st["submissions"] - before["submissions"])
            / launches if launches else 0.0,
            "profiler_by_kind": prof.profile(last=0)["by_kind"]}


def phase_recovery_storm(dev, rng) -> tuple[dict, dict]:
    """Phase H: the path an OSD-loss storm takes, through one per-host
    ECLaunchQueue on the card.  torch k=8 m=3: N_STORM_PGS PGs x
    N_STORM_OBJECTS objects of 4 MiB (RBD) and of 64 KiB (small S3
    objects) written through the queue (K3 / K2's flat entry), then one
    shard and then shards {0, 9} lost and recovered (K1 decodes through
    the queue).  CLAY k=8 m=4 d=11: 2 PGs x 16 objects of 4 MiB, one
    chunk lost and repaired from repair planes through the queue (K4).
    Kernel launch counters are zeroed before each recovery and each
    write and read after it; every recovery must have run its kernel.
    Returns (launch counts by step, the report)."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.ops.profiler import device_profiler
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.store import MemStore

    prof = device_profiler()
    report = {"card": nvidia_smi_line(), "pgs": N_STORM_PGS,
              "objects_per_pg": N_STORM_OBJECTS}
    counts = {}
    t_phase = time.perf_counter()
    for size, tag in ((BIG, "4MiB"), (SMALL, "64KiB")):
        store = MemStore()
        store.mount()
        queue = ECLaunchQueue(window_us=STORM_WINDOW_US, device=dev)
        try:
            backends = storm_pgs(dev, queue, "torch",
                                 {"k": str(K), "m": str(M),
                                  "device": str(dev)}, N_STORM_PGS, store)
            bs.reset_launch_counts()
            prof.reset()
            before = storm_snapshot(queue, prof)
            t0 = time.perf_counter()
            objs = storm_write(backends, rng, size, N_STORM_OBJECTS)
            torch.cuda.synchronize()
            t_write = time.perf_counter() - t0
            step = storm_counts(bs, queue, prof, before)
            step.update(wall_s=t_write,
                        write_GBps=len(objs) * size / t_write / 1e9)
            counts[f"storm_{tag}_write"] = step["kernel_launches"]
            # 512 KiB runs take K3 at the pinned point, 8 KiB runs K2's
            # flat entry
            entry = "fused_hier_acc_call" if size == BIG \
                else "gf_encode_with_crc_w32"
            if step["kernel_launches"][entry] <= 0 or \
                    step["cross_pg_launches"] <= 0:
                raise AssertionError(f"storm {tag} writes: no {entry} "
                                     f"launch across PGs: {step}")
            report[f"{tag}_write"] = step
            for missing in STORM_LOSSES:
                name = f"storm_{tag}_lose{''.join(map(str, missing))}"
                bs.reset_launch_counts()
                prof.reset()
                before = storm_snapshot(queue, prof)
                res = storm_recover(backends, objs, missing)
                res.update(storm_counts(bs, queue, prof, before))
                counts[name] = res["kernel_launches"]
                if counts[name]["gf_bitmatmul"] <= 0 or \
                        res["decode_launches"] <= 0:
                    raise AssertionError(f"{name}: no K1 decode launch")
                report[name] = res
                print(f"# {name}: {res['rebuilt_bytes']} B rebuilt in "
                      f"{res['wall_s']:.4f} s, {res['rebuilt_GBps']:.3f} "
                      f"GB/s, {res['decode_launches']} decode launches, "
                      f"{res['cross_pg_launches']} cross-PG", flush=True)
            report[f"{tag}_queue"] = queue.status()
        finally:
            queue.close()
    if report["storm_64KiB_lose3"]["cross_pg_launches"] < 1:
        raise AssertionError("the small-object storm coalesced no decode "
                             "across PGs")
    # CLAY k=8 m=4 d=11: one chunk lost, repaired through the queue (K4)
    ck, cm, cd = CLAY_PROFILES["k8m4d11"]
    store = MemStore()
    store.mount()
    queue = ECLaunchQueue(window_us=STORM_WINDOW_US, device=dev)
    try:
        backends = storm_pgs(dev, queue, "clay",
                             {"k": str(ck), "m": str(cm), "d": str(cd)},
                             N_CLAY_STORM_PGS, store)
        t0 = time.perf_counter()
        objs = storm_write(backends, rng, BIG, N_CLAY_STORM_OBJECTS)
        t_write = time.perf_counter() - t0
        bs.reset_launch_counts()
        prof.reset()
        before = storm_snapshot(queue, prof)
        res = storm_recover(backends, objs, (CLAY_STORM_LOST,))
        res.update(storm_counts(bs, queue, prof, before))
        res["host_encode_write_s"] = t_write
        res["clay_repairs"] = sum(be.repair_status()["clay_repairs"]
                                  for be in backends)
        counts["storm_clay_k8m4d11"] = res["kernel_launches"]
        if counts["storm_clay_k8m4d11"]["gf_bitmatmul_stream"] <= 0 or \
                res["repair_launches"] <= 0 or \
                res["clay_repairs"] != len(objs):
            raise AssertionError(f"CLAY storm did not repair through K4: "
                                 f"{res}")
        report["storm_clay_k8m4d11"] = res
        print(f"# storm_clay_k8m4d11: {res['rebuilt_bytes']} B rebuilt in "
              f"{res['wall_s']:.4f} s, {res['rebuilt_GBps']:.3f} GB/s, "
              f"{res['repair_launches']} repair launches", flush=True)
    finally:
        queue.close()
    report["phase_s"] = time.perf_counter() - t_phase
    return counts, report


# Phase I: the reference's deep-scrub bench setting (bench.py
# time_deep_scrub at its card sizes): k=8 m=3, objects of 8 MiB, a
# 16 KiB stripe unit, so 1 MiB shard rows, scrub chunks of
# SCRUB_CHUNK_BYTES (64 MiB)
SCRUB_OBJECT = 8 << 20
SCRUB_STRIPE_UNIT = 16 << 10
N_SCRUB_PGS = 4
N_SCRUB_OBJECTS = 16
# tail objects: with a 4 or 16 KiB stripe unit every shard row is whole
# 2 KiB blocks, so a fifth PG with a 1 KiB unit holds 8 objects of
# 8 MiB + 777 B, whose rows end in a 1 KiB tail the host folds
SCRUB_TAIL_UNIT = 1 << 10
SCRUB_TAIL_SIZE = (8 << 20) + 777
N_SCRUB_TAIL_OBJECTS = 8
# the rot: (PG, object, shard), data and parity shards of different
# objects, the last one a byte in a tail (5 bytes before the row's end)
SCRUB_ROT = ((0, 1, 0), (0, 7, 9), (1, 2, 3), (1, 13, 10), (2, 5, 5),
             (3, 0, 7), (3, 15, 1), (4, 3, 2))


def scrub_pgs(dev, store) -> list:
    """The backends of phase I on the card over one MemStore: torch k=8
    m=3 at the pinned K3 point, N_SCRUB_PGS PGs with the 16 KiB stripe
    unit and one with the 1 KiB unit of the tail objects."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import pg_t
    out = []
    units = [SCRUB_STRIPE_UNIT] * N_SCRUB_PGS + [SCRUB_TAIL_UNIT]
    for i, unit in enumerate(units):
        codec = ErasureCodePluginRegistry.instance().factory(
            "torch", {"k": str(K), "m": str(M), "device": str(dev)})
        shards = LocalShardBackend(store, pg_t(3, i), K + M)
        out.append(ECBackend(codec, StripeInfo(K * unit, unit), shards,
                             device=dev))
    return out


def scrub_chunks(row_bytes: list[int]) -> int:
    """K5 launches scrub_pg makes over objects of `row_bytes` shard rows
    (k+m rows each): its chunk budget closes a chunk at
    SCRUB_CHUNK_BYTES."""
    from ceph_tpu_torch.osd.scrub import SCRUB_CHUNK_BYTES
    chunks = budget = 0
    for n in row_bytes:
        budget += n * (K + M)
        if budget >= SCRUB_CHUNK_BYTES:
            chunks, budget = chunks + 1, 0
    return chunks + (budget > 0)


def scrub_all(backends, oids, **kw) -> tuple[list, float]:
    """Deep-scrub every PG of phase I; (results, wall seconds)."""
    from ceph_tpu_torch.osd import scrub
    t0 = time.perf_counter()
    res = [scrub.scrub_pg(be, o, deep=True, **kw)
           for be, o in zip(backends, oids)]
    return res, time.perf_counter() - t0


def phase_deep_scrub(dev, rng) -> tuple[dict, dict]:
    """Phase I: deep scrub of 4 PGs x 16 objects of 8 MiB (704 MiB of
    shards) and one PG of 8 objects of 8 MiB + 777 B, written on the
    card.  A clean scrub (one K5 launch a 64 MiB chunk, tails folded on
    the host) must find nothing; then 8 shards rot (SCRUB_ROT) and a
    scrub with repair must find each as crc_mismatch on its shard and
    rebuild it (K1) to its original bytes; then the same PGs on the
    host crc32c, and the device path once more.  Returns (launch counts
    by step, the report)."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.osd.ec_transaction import PGTransaction, shard_oid
    from ceph_tpu_torch.osd.types import eversion_t, hobject_t
    from ceph_tpu_torch.store import MemStore
    from ceph_tpu_torch.store.object_store import Transaction

    store = MemStore()
    store.mount()
    backends = scrub_pgs(dev, store)
    sizes = [SCRUB_OBJECT] * N_SCRUB_PGS + [SCRUB_TAIL_SIZE]
    n_objs = [N_SCRUB_OBJECTS] * N_SCRUB_PGS + [N_SCRUB_TAIL_OBJECTS]
    oids, acks = [], []
    t0 = time.perf_counter()
    for p, (be, size, n) in enumerate(zip(backends, sizes, n_objs)):
        oids.append([hobject_t(pool=3, name=f"s{p}_{i}") for i in range(n)])
        with be.pipeline():
            for i, o in enumerate(oids[-1]):
                txn = PGTransaction()
                txn.write(o, 0, np.frombuffer(rng.bytes(size),
                                              dtype=np.uint8))
                be.submit_transaction(txn, eversion_t(1, i + 1),
                                      lambda: acks.append(1))
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    if len(acks) != sum(n_objs):
        raise AssertionError(f"{len(acks)} of {sum(n_objs)} writes acked")
    rows = [[be.shards.stat(0, o) for o in os_]
            for be, os_ in zip(backends, oids)]
    shard_bytes = sum(sum(r) for r in rows) * (K + M)
    tail_bytes = sum(n % 2048 for r in rows for n in r) * (K + M)
    want_k5 = sum(scrub_chunks(r) for r in rows)
    counts = {}
    report = {"card": nvidia_smi_line(), "pgs": len(backends),
              "objects": sum(n_objs), "shard_bytes": shard_bytes,
              "write_s": t_write}

    def check_clean(res, tag):
        bad = [e for r in res for e in r.errors]
        if bad or sum(r.objects for r in res) != sum(n_objs):
            raise AssertionError(f"{tag}: {len(bad)} errors, first "
                                 f"{bad[:1]!r}")

    # 1. the clean PGs
    bs.reset_launch_counts()
    res, wall = scrub_all(backends, oids)
    counts["deep_scrub"] = bs.launch_counts()
    check_clean(res, "clean scrub")
    dev_b = sum(r.device_bytes for r in res)
    host_b = sum(r.host_bytes for r in res)
    k5 = counts["deep_scrub"]["crc32c_rows_l"]
    if dev_b + host_b != shard_bytes or host_b != tail_bytes or \
            k5 != want_k5:
        raise AssertionError(f"clean scrub: {dev_b} device + {host_b} host "
                             f"bytes of {shard_bytes} ({tail_bytes} in "
                             f"tails), {k5} K5 launches of {want_k5}")
    report["device"] = {"wall_s": wall, "GBps": shard_bytes / wall / 1e9,
                        "k5_launches": k5, "device_bytes": dev_b,
                        "host_bytes": host_b}
    # 2. rot: flip bytes in 8 shards
    original, rotted = {}, set()
    for p, i, s in SCRUB_ROT:
        sh = backends[p].shards
        g = shard_oid(oids[p][i], s)
        data = sh.store.read(sh.cids[s], g)
        original[(p, i, s)] = data.copy()
        off = data.size - 5 if p == N_SCRUB_PGS else 4099
        t = Transaction()
        t.write(g, off, np.array([data[off] ^ 0xA5], dtype=np.uint8))
        sh.store.queue_transactions(sh.cids[s], [t])
        rotted.add((oids[p][i].name, s))
    # 3. scrub with repair
    bs.reset_launch_counts()
    res, wall_r = scrub_all(backends, oids, repair=True)
    counts["deep_scrub_repair"] = bs.launch_counts()
    check_clean(res, "repair scrub")
    found = {(e.oid.name, e.shard) for r in res for e in r.repaired
             if e.kind == "crc_mismatch"}
    kinds = {e.kind for r in res for e in r.repaired}
    if found != rotted or kinds != {"crc_mismatch"}:
        raise AssertionError(f"repair found {sorted(found)} ({kinds}), "
                             f"rotted {sorted(rotted)}")
    for (p, i, s), want in original.items():
        sh = backends[p].shards
        if not np.array_equal(sh.store.read(sh.cids[s],
                                            shard_oid(oids[p][i], s)), want):
            raise AssertionError(f"shard {s} of {oids[p][i].name} was not "
                                 "restored")
    k1 = counts["deep_scrub_repair"]["gf_bitmatmul"]
    if k1 <= 0:
        raise AssertionError("repair decoded through no K1 launch")
    report["repair"] = {"wall_s": wall_r, "rotted": len(rotted),
                        "repaired": len(found), "k1_launches": k1,
                        "k5_launches":
                        counts["deep_scrub_repair"]["crc32c_rows_l"]}
    # 4. the host path (native crc32c) on the same PGs, then the device
    # path once more
    res, wall_h = scrub_all(backends, oids, use_device=False)
    check_clean(res, "host scrub")
    if sum(r.host_bytes for r in res) != shard_bytes:
        raise AssertionError("host scrub did not verify every byte")
    report["host"] = {"wall_s": wall_h, "GBps": shard_bytes / wall_h / 1e9}
    res, wall_2 = scrub_all(backends, oids)
    check_clean(res, "second device scrub")
    report["device_again"] = {"wall_s": wall_2,
                              "GBps": shard_bytes / wall_2 / 1e9}
    print(f"# deep scrub: {shard_bytes} B verified; device path "
          f"{wall:.4f} s {report['device']['GBps']:.3f} GB/s (again "
          f"{wall_2:.4f} s {report['device_again']['GBps']:.3f} GB/s), "
          f"host path {wall_h:.4f} s {report['host']['GBps']:.3f} GB/s; "
          f"{k5} K5 launches, {dev_b} device B, {host_b} host B; repair "
          f"{len(found)}/{len(rotted)} shards with {k1} K1 launches",
          flush=True)
    return counts, report


# Graph times of the two K3 rows before K3's redesign (PERF.md §6:
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W), the `earlier`
# column of the K3 table
K3_EARLIER_US = {"gf_encode_crc_acc (K3, one 512 KiB run)": 20.672,
                 "gf_encode_crc_acc (K3, 2 runs, one odd-width)": 29.206}


def k3_block_table(dev, bs, gf, rng, rows) -> dict:
    """K3 on one 8+3 x 512 KiB run at B = 1, 2 and 4 KiB (the
    autotuner's wb 256, 512, 1024): the wrapper (its L zero-fill plus
    the kernel), the kernel alone (the C entry on a slot zeroed once,
    its XORs left to pile up while timed), and K2's hier entry at the
    same block as this run's control; each checked exactly against its
    plain version, then timed as the kernel rows are (graph replays).
    Also the zero-fill of the L slots alone, and the two K3 kernel rows
    beside their times before the redesign."""
    from ceph_tpu_torch.ops import _build
    lib = _build.load()
    enc = bs.tables_tensor(gf.product_tables(gf.cauchy_rs_matrix(K, M)[K:]),
                           dev)
    run = BIG // K
    data = torch.from_numpy(
        rng.integers(0, 256, (K, run), dtype=np.uint8)).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fill_us = graph_event_ms(lambda: torch.zeros(
        (1, K + M), dtype=torch.int64, device=dev)) * 1e3
    by_block = []
    for wb in (256, 512, 1024):
        block = 4 * wb
        staged, ends = bs._acc_launch_args([run // block], dev)
        torch.cuda.synchronize()
        del staged
        want = bs.fused_hier_acc_call_plain(enc, data, ends, wb)
        got = bs.fused_hier_acc_call(enc, data, ends, wb)
        k2, k2_want = (bs.fused_hier_call(enc, data, wb),
                       bs.fused_hier_call_plain(enc, data, wb))
        ops = bs._k3_ops_tensor(block, dev)
        parity = torch.empty((M, run), dtype=torch.uint8, device=dev)
        lacc = torch.zeros((1, K + M), dtype=torch.int64, device=dev)

        def alone():
            rc = lib.ctt_gf_encode_crc_acc(
                enc.data_ptr(), data.data_ptr(), parity.data_ptr(),
                lacc.data_ptr(), ops.data_ptr(), ends.data_ptr(), 1, M, K,
                run, block, bs.K3_DIGITS,
                torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
        alone()
        torch.cuda.synchronize()
        for name, a, b in (("K3", got, want), ("K3 alone", (parity, lacc),
                                                want), ("K2 hier", k2,
                                                        k2_want)):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{name} at B = {block} differs from "
                                     "its plain version")
        t_bound, _ = bound(K * run + M * run + (K + M) * 8,
                           2 * M * K * run + 2 * (K + M) * run)
        row = {"block": block, "wb": wb,
               "grid": bs.k3_launch(run, block, K, M, sms),
               "k3_us": graph_event_ms(
                   lambda: bs.fused_hier_acc_call(enc, data, ends, wb)) * 1e3,
               "k3_alone_us": graph_event_ms(alone) * 1e3,
               "k2_hier_us": graph_event_ms(
                   lambda: bs.fused_hier_call(enc, data, wb)) * 1e3,
               "bound_us": t_bound * 1e3}
        by_block.append(row)
        print(f"# k3_table B={block:5d} grid={row['grid']:4d}  K3 "
              f"{row['k3_us']:8.3f} us  alone {row['k3_alone_us']:8.3f} us  "
              f"K2 hier {row['k2_hier_us']:8.3f} us  bound "
              f"{row['bound_us']:.3f} us", flush=True)
    print(f"# k3_table L zero-fill alone {fill_us:.3f} us", flush=True)
    earlier = [{"name": r["name"], "earlier_us": K3_EARLIER_US[r["name"]],
                "us": r["ms"] * 1e3, "single_us": r["single_ms"] * 1e3,
                "cold_us": r["cold_ms"] * 1e3, "bound_us": r["bound_ms"] * 1e3}
               for r in rows if r["name"] in K3_EARLIER_US]
    if len(earlier) != 2:
        raise AssertionError(f"K3 rows missing: {[r['name'] for r in rows]}")
    return {"fill_us": fill_us, "by_block": by_block, "rows": earlier}


# Graph times of the K2 and K3 rows before K2's redesign (the final
# chip_smoke.py run of K3's redesign on an NVIDIA H100 80GB HBM3 at
# 700 W: PERF.md §6's rows and its K3 table's K2 control at B = 2 and
# 4 KiB; 1 KiB not recorded), the `earlier` column of the K2 table
K2_EARLIER_US = {"fused_hier_call (K2, 2 KiB sub-blocks)": 17.085,
                 "gf_encode_with_crc_w32 (K2, 2 KiB tiles)": 13.936,
                 "gf_encode_with_crc (K2 byte entry, 2 KiB tiles)": 17.014,
                 "gf_encode_crc_acc (K3, one 512 KiB run)": 12.538,
                 "gf_encode_crc_acc (K3, 2 runs, one odd-width)": 19.034}
K2_EARLIER_BLOCK_US = {1024: None, 2048: 17.14, 4096: 21.77}


def k2_block_table(bs, sms: int, k3_table: dict, rows) -> dict:
    """K2 against its times before the redesign: its hier entry on one
    8+3 x 512 KiB run at B = 1, 2 and 4 KiB (checked exactly against
    its plain version and timed by k3_block_table) with its grid, and
    its three kernel rows; K3 at the same blocks and K3's kernel rows
    as this run's control."""
    run = BIG // K
    by_block = []
    for r in k3_table["by_block"]:
        row = {"block": r["block"], "wb": r["wb"],
               "grid": bs.k3_launch(run, r["block"], K, M, sms, acc=False),
               "us": r["k2_hier_us"],
               "earlier_us": K2_EARLIER_BLOCK_US[r["block"]],
               "k3_us": r["k3_us"], "k3_alone_us": r["k3_alone_us"],
               "bound_us": r["bound_us"]}
        by_block.append(row)
        print(f"# k2_table B={row['block']:5d} grid={row['grid']:4d}  K2 "
              f"hier {row['us']:8.3f} us (earlier {row['earlier_us']})  K3 "
              f"alone {row['k3_alone_us']:8.3f} us", flush=True)
    kernel_rows = [{"name": r["name"], "earlier_us": K2_EARLIER_US[r["name"]],
                    "control": r["name"] in K3_EARLIER_US,
                    "us": r["ms"] * 1e3, "single_us": r["single_ms"] * 1e3,
                    "cold_us": r["cold_ms"] * 1e3,
                    "bound_us": r["bound_ms"] * 1e3}
                   for r in rows if r["name"] in K2_EARLIER_US]
    if len(kernel_rows) != 5:
        raise AssertionError(f"K2/K3 rows missing: "
                             f"{[r['name'] for r in rows]}")
    for r in kernel_rows:
        print(f"# k2_table {r['name']}: {r['us']:.3f} us (earlier "
              f"{r['earlier_us']})", flush=True)
    return {"by_block": by_block, "rows": kernel_rows}


# Phase J: boot.  CephContext -> compile cache -> prewarm -> mesh service,
# as the reference daemon boots (ceph_tpu/osd/daemon.py:475-485,
# 3785-3819, 3990-4011), then the recovery storm's first write and first
# recovery pass (phase H's 4 MiB storm: 4 PGs x 64 x 4 MiB, shard 3
# lost), each in a fresh process, with the prewarm off and on
BOOT_CHILD_TIMEOUT_S = 300
BOOT_BUDGET_S = 60.0
# the storm's stage widths: 512 KiB runs a shard (4 MiB objects at k=8),
# coalesced up to 8 a launch (the queue's 32 MiB cap), decoded one object
# a launch (each wider than the 64 KiB decode cap)
BOOT_PREWARM = {"widths": [(BIG // K) * r for r in (1, 2, 4, 8)],
                "run_counts": [1, 2, 4, 8],
                "decode_widths": [BIG // K]}


def boot(conf: dict, plugin, prewarm_kwargs: dict | None = None):
    """The port's boot sequence: a CephContext configured from `conf`,
    the kernel library cache (osd_ec_compile_cache[_dir]), the prewarm of
    `plugin`'s buckets (osd_ec_prewarm, its budget
    osd_ec_prewarm_budget_s) seeding the host's flight recorder, and the
    host's MeshService (osd_ec_use_mesh, mesh_devices).  Returns (cct,
    the prewarm status or None, the service or None)."""
    from ceph_tpu_torch.common.context import CephContext
    from ceph_tpu_torch.ops import compile_cache, prewarm
    from ceph_tpu_torch.ops.profiler import device_profiler
    from ceph_tpu_torch.parallel.service import MeshService
    cct = CephContext("osd.0")
    for key, value in conf.items():
        cct.conf.set(key, value)
    if cct.conf.get("osd_ec_compile_cache"):
        compile_cache.enable(
            str(cct.conf.get("osd_ec_compile_cache_dir")) or None)
    prof = device_profiler()
    prof.set_ring_size(int(cct.conf.get("osd_ec_profiler_ring")))
    status = None
    if cct.conf.get("osd_ec_prewarm"):
        status = prewarm.run_once(
            plugin, profiler=prof,
            budget_s=float(cct.conf.get("osd_ec_prewarm_budget_s")),
            **(prewarm_kwargs or {}))
    svc = None
    if cct.conf.get("osd_ec_use_mesh"):
        svc = MeshService.get_or_configure(str(cct.conf.get("mesh_devices")))
    return cct, status, svc


def ledger_by_kind(ledger: dict) -> dict:
    """The compile ledger's buckets by kind (the label's prefix): how
    many, how many prewarmed, the largest and summed first-launch
    seconds, and the least steady (later) submit seconds."""
    out = {}
    for row in ledger["buckets"]:
        kind = row["bucket"].split(":")[0]
        e = out.setdefault(kind, {"buckets": 0, "prewarmed": 0,
                                  "first_s_max": 0.0, "first_s_sum": 0.0,
                                  "steady_s_min": None})
        e["buckets"] += 1
        e["prewarmed"] += row["prewarmed"]
        e["first_s_max"] = max(e["first_s_max"], row["first_s"])
        e["first_s_sum"] += row["first_s"]
        if row["steady_s"] is not None:
            e["steady_s_min"] = row["steady_s"] if e["steady_s_min"] is None \
                else min(e["steady_s_min"], row["steady_s"])
    return out


def boot_child(mode: str) -> int:
    """One phase J boot, in its own process: boot (prewarm `mode` "on"
    or "off"), then the 4 MiB storm's first write and first recovery
    pass through one ECLaunchQueue.  Prints one JSON line."""
    from ceph_tpu_torch import resolve_device
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.ops import compile_cache
    from ceph_tpu_torch.ops.profiler import device_profiler
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.store import MemStore
    t0 = time.perf_counter()
    dev = resolve_device("cuda")
    profile = {"k": str(K), "m": str(M), "device": str(dev)}
    plugin = ErasureCodePluginRegistry.instance().factory("torch", profile)
    _cct, status, _svc = boot({"osd_ec_prewarm": mode == "on",
                               "osd_ec_prewarm_budget_s": BOOT_BUDGET_S},
                              plugin, BOOT_PREWARM)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    prof = device_profiler()
    rng = np.random.default_rng(SEED)
    store = MemStore()
    store.mount()
    queue = ECLaunchQueue(window_us=STORM_WINDOW_US, device=dev)
    try:
        backends = storm_pgs(dev, queue, "torch", profile, N_STORM_PGS,
                             store)
        bs.reset_launch_counts()
        before = storm_snapshot(queue, prof)
        t1 = time.perf_counter()
        objs = storm_write(backends, rng, BIG, N_STORM_OBJECTS)
        torch.cuda.synchronize()
        write = storm_counts(bs, queue, prof, before)
        write["wall_s"] = time.perf_counter() - t1
        bs.reset_launch_counts()
        before = storm_snapshot(queue, prof)
        recover = storm_recover(backends, objs, (3,))
        recover.update(storm_counts(bs, queue, prof, before))
    finally:
        queue.close()
    for step in (write, recover):
        step["submit_share"] = step["launch_submit_s"] / step["wall_s"]
    if write["kernel_launches"]["fused_hier_acc_call"] <= 0 or \
            recover["kernel_launches"]["gf_bitmatmul"] <= 0:
        raise AssertionError(f"boot {mode}: the storm missed its kernels")
    ledger = prof.compile_ledger()
    print(json.dumps({"mode": mode, "boot_s": boot_s, "prewarm": status,
                      "compile_cache": compile_cache.status(),
                      "ledger_by_kind": ledger_by_kind(ledger),
                      "compile_stalls": ledger["compile_stalls"],
                      "write": write, "recover": recover}), flush=True)
    return 0


def phase_boot() -> dict:
    """Phase J: two fresh processes, one after the other, each loading
    the kernel library the parent built: prewarm off, then on.  Each
    must rebuild every lost shard; the prewarm must run every entry
    (skipped 0) and load the library rather than build it."""
    report = {"card": nvidia_smi_line()}
    for mode in ("off", "on"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--boot-child", mode],
            capture_output=True, text=True, timeout=BOOT_CHILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"boot {mode} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        if res["compile_cache"]["kernel_library"]["builds_in_process"] or \
                not res["compile_cache"]["enabled"]:
            raise AssertionError(f"boot {mode} did not load the parent's "
                                 f"library: {res['compile_cache']}")
        st = res["prewarm"]
        if mode == "on" and (st is None or st["skipped"] or
                             st["done"] != st["planned"] or st["compiles"]):
            raise AssertionError(f"boot prewarm incomplete: {st}")
        if st is not None:
            st.pop("buckets")
        report[mode] = res
        print(f"# boot prewarm={mode}: boot {res['boot_s']:.3f} s; first "
              f"write {res['write']['wall_s']:.4f} s, "
              f"{100 * res['write']['submit_share']:.1f}% in launch "
              f"submits; first recovery {res['recover']['wall_s']:.4f} s, "
              f"{100 * res['recover']['submit_share']:.1f}% in launch "
              f"submits" + (f"; prewarm {st['done']}/{st['planned']} "
                            f"entries, skipped {st['skipped']}, "
                            f"{st['total_s']} s" if st else ""), flush=True)
    return report


# Phase K: the mesh.  k=8 m=3 (ISA-L's canonical profile), 4 MiB objects
# (RBD's object size); the service mesh is 1x1 on the card, the sharded
# meshes 4x1 and 2x2 repeat the card, a 1x1 mesh is their control (one
# launch a call, the single-card plane's shape)
N_MESH_OBJECTS = 32
MESH_LOST = (3,)
MESH_DECODE_ERASED = (0, 9)
SHARDED_MESHES = ((1, 1), (4, 1), (2, 2))
MESH_TIMED_RUNS = 3


def phase_mesh(dev, rng) -> tuple[dict, dict]:
    """Phase K: (a) the service mesh through boot(): MeshService "1"
    (1x1 on the card) and an ECBackend through it: 32 x 4 MiB writes
    (plain-encoded on the mesh, crcs on the host), every object read back
    and read with shards 0 and 1 down, then shard 3 of all 32 objects
    lost and rebuilt in one recover_shards_batch (one mesh decode);
    ec_mesh_drains > 0, ec_mesh_errors == 0, mesh_error None.  (b) 4x1
    and 2x2 meshes repeating the card (and a 1x1 control): encode_flat
    of 8 x 4 MiB, decode_flat_batch of 32 objects missing {0, 9},
    clay_repair_batch on k8m4d11's plan over 32 objects, each byte-equal
    to the single-card plane (the torch plugin, ClayRepairPlan.
    apply_batch); the median wall of MESH_TIMED_RUNS calls.  (c) one
    torch.cuda.nccl.all_gather of a one-member list.  Returns (launch
    counts by step, the report)."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.parallel import ClayRepairPlan
    from ceph_tpu_torch.parallel.mesh import DistributedStripeCodec, make_mesh
    from ceph_tpu_torch.parallel.service import MeshService

    report = {"card": nvidia_smi_line()}
    counts = {}
    MeshService.reset()
    try:
        _cct, _st, svc = boot({"osd_ec_use_mesh": True, "mesh_devices": "1"},
                              None)
        codec, sinfo, store, shards, be = make_backend(dev, None, svc)
        if be.mesh_codec is None:
            raise AssertionError(f"no mesh codec: {be.mesh_error}")
        w = Writer(be, rng)
        data = {f"mesh{i}": w.payload(BIG) for i in range(N_MESH_OBJECTS)}
        torch.cuda.synchronize()
        bs.reset_launch_counts()
        t0 = time.perf_counter()
        with be.pipeline():
            for name, payload in data.items():
                w.submit(name, 0, payload)
        t_write = time.perf_counter() - t0
        counts["mesh_service_write"] = bs.launch_counts()
        if w.acks != list(range(1, w.version + 1)):
            raise AssertionError("mesh writes: acks out of order or missing")
        w.check_readback()
        check_parity(codec, sinfo, store, shards, w,
                     f"mesh{N_MESH_OBJECTS - 1}")
        n_crc = check_crcs(store, shards, w)
        if n_crc != N_MESH_OBJECTS:
            raise AssertionError(f"only {n_crc} mesh objects carry a crc")
        bs.reset_launch_counts()
        nread, t_deg = degraded_reads(be, shards, w, data)
        counts["mesh_service_read"] = bs.launch_counts()
        objs = {(0, name): payload for name, payload in data.items()}
        bs.reset_launch_counts()
        rec = storm_recover([be], objs, MESH_LOST, step=N_MESH_OBJECTS,
                            pool=1)
        counts["mesh_service_recover"] = bs.launch_counts()
        dump = be.perf.dump()
        mesh = {c: dump[c] for c in ("ec_mesh_drains",
                                     "ec_mesh_repair_launches",
                                     "ec_mesh_errors")}
        if be.mesh_error is not None or mesh["ec_mesh_errors"] or \
                mesh["ec_mesh_drains"] <= 0 or \
                mesh["ec_mesh_repair_launches"] != 1:
            raise AssertionError(f"mesh plane: {mesh}, {be.mesh_error}")
        for step in ("write", "read", "recover"):
            if counts[f"mesh_service_{step}"]["gf_bitmatmul"] <= 0:
                raise AssertionError(f"mesh {step}: no K1 launch")
        report["service"] = {
            "status": svc.status(), "backend": be.mesh_status(),
            "counters": mesh, "objects": N_MESH_OBJECTS,
            "write_GBps": N_MESH_OBJECTS * BIG / t_write / 1e9,
            "write_s": t_write,
            "degraded_read_GBps": nread / t_deg / 1e9,
            "degraded_read_s": t_deg, "recover": rec}
        print(f"# mesh service 1x1 (gather {svc.mesh.gather}): write "
              f"{report['service']['write_GBps']:.4f} GB/s, degraded read "
              f"{report['service']['degraded_read_GBps']:.4f} GB/s, "
              f"recovery {rec['rebuilt_GBps']:.4f} GB/s rebuilt; {mesh}",
              flush=True)
    finally:
        MeshService.reset()

    # (b) sharded meshes repeating the card, against the single-card plane
    data = np.frombuffer(rng.bytes(K * 8 * (BIG // K)), dtype=np.uint8) \
        .reshape(K, -1)
    survivors = tuple(s for s in range(K + M)
                      if s not in MESH_DECODE_ERASED)[:K]
    objs = [np.frombuffer(rng.bytes(BIG), dtype=np.uint8).reshape(K, -1)
            for _ in range(N_MESH_OBJECTS)]
    full = [np.concatenate([o, codec.encode_chunks(o)]) for o in objs]
    avail = [f[list(survivors)] for f in full]
    ck, cm, cd = CLAY_PROFILES["k8m4d11"]
    clay = clay_codec(ck, cm, cd)
    plan = ClayRepairPlan.build(clay, CLAY_STORM_LOST, device=dev)
    rows = [np.frombuffer(rng.bytes(plan.in_rows * clay_sub_size(clay)),
                          dtype=np.uint8).reshape(plan.in_rows, -1)
            for _ in range(N_MESH_OBJECTS)]
    single = {"encode": codec.encode_chunks(data),
              "decode": [codec.decode_chunks(f, list(MESH_DECODE_ERASED))
                         [list(MESH_DECODE_ERASED)] for f in full],
              "clay": plan.apply_batch(rows)}
    for n_shard, n_data in SHARDED_MESHES:
        name = f"{n_shard}x{n_data}"
        dcodec = DistributedStripeCodec(
            K, M, make_mesh(n_shard, n_data, [dev] * (n_shard * n_data)))
        res = {"gather": dcodec.mesh.gather}
        steps = (
            ("encode", data.size,
             lambda: dcodec.encode_flat(data),
             lambda got: np.array_equal(got, single["encode"])),
            ("decode", sum(a.size for a in avail),
             lambda: dcodec.decode_flat_batch(avail, survivors,
                                              MESH_DECODE_ERASED),
             lambda got: all(np.array_equal(g, s)
                             for g, s in zip(got, single["decode"]))),
            ("clay", sum(r.size for r in rows),
             lambda: dcodec.clay_repair_batch(plan, rows),
             lambda got: all(np.array_equal(g, s)
                             for g, s in zip(got, single["clay"]))))
        for step, nbytes, run, same in steps:
            run()                       # tables built, first launch done
            torch.cuda.synchronize()
            bs.reset_launch_counts()
            t0 = time.perf_counter()
            got = run()
            walls = [time.perf_counter() - t0]
            counts[f"mesh_{name}_{step}"] = bs.launch_counts()
            for _ in range(MESH_TIMED_RUNS - 1):
                t0 = time.perf_counter()
                run()
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            if not same(got):
                raise AssertionError(f"mesh {name} {step} differs from the "
                                     "single-card plane")
            k1 = counts[f"mesh_{name}_{step}"]["gf_bitmatmul"]
            k4 = counts[f"mesh_{name}_{step}"]["gf_bitmatmul_stream"]
            want = (0, n_shard * n_data) if step == "clay" \
                else (n_shard * n_data, 0)
            if (k1, k4) != want:
                raise AssertionError(f"mesh {name} {step}: K1 {k1}, K4 {k4} "
                                     f"launches, expected {want}")
            res[step] = {"in_bytes": nbytes, "wall_s": wall,
                         "walls_s": walls,
                         "GBps": nbytes / wall / 1e9, "k1": k1, "k4": k4}
            print(f"# mesh {name} (gather {dcodec.mesh.gather}) {step}: "
                  f"{nbytes / wall / 1e9:.3f} GB/s in, K1 {k1}, K4 {k4}",
                  flush=True)
        report[name] = res

    # (c) the NCCL binding: one all_gather of a one-member list
    x = torch.arange(1024, device=dev).to(torch.uint8)
    out = torch.empty_like(x)
    torch.cuda.nccl.all_gather([x], [out])
    torch.cuda.synchronize()
    if not torch.equal(out, x):
        raise AssertionError("nccl all_gather of one member differs")
    report["nccl"] = {"all_gather_one_member": "ok",
                      "version": torch.cuda.nccl.version()}
    print(f"# nccl {torch.cuda.nccl.version()}: one-member all_gather ok",
          flush=True)
    return counts, report


def pin_point(cache_file, dev, point: dict) -> None:
    """Pin the fused write path's operating point the way an operator
    does: a cache row for this card's key, and CEPH_TPU_AUTOTUNE_CACHE
    pointing at the file."""
    from ceph_tpu_torch.ops import autotune
    key = autotune._device_key(dev, K, M)
    cache_file.write_text(json.dumps({"version": 2, "entries": {
        key: {**point, "gbps": 0.0, "when": "pinned"}}}))
    os.environ["CEPH_TPU_AUTOTUNE_CACHE"] = str(cache_file)


def make_backend(dev, stages, mesh_service=None):
    """A torch codec (its point read from the autotune cache) and an
    ECBackend over MemStore whose shards can be made to fail reads;
    `stages` None keeps the backend's own counters, and a MeshService
    puts it on the mesh plane."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import pg_t
    from ceph_tpu_torch.store import MemStore

    class DegradedShards(LocalShardBackend):
        down: set = set()

        def sub_read(self, shard, oid, off, length, on_done):
            if shard in self.down:
                on_done(shard, None)
                return
            super().sub_read(shard, oid, off, length, on_done)

    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": str(K), "m": str(M), "technique": "cauchy",
                  "device": str(dev)})
    sinfo = StripeInfo(stripe_width=K * STRIPE_UNIT, chunk_size=STRIPE_UNIT)
    store = MemStore()
    store.mount()
    shards = DegradedShards(store, pg_t(1, 0), K + M)
    be = ECBackend(codec, sinfo, shards, dispatch_depth=2, perf=stages,
                   mesh_service=mesh_service)
    return codec, sinfo, store, shards, be


class Writer:
    """Submits writes to one backend and keeps the expected bytes."""

    def __init__(self, be, rng):
        self.be = be
        self.rng = rng
        self.expect: dict[str, np.ndarray] = {}
        self.version = 0
        self.acks = []

    @staticmethod
    def oid(name):
        from ceph_tpu_torch.osd.types import hobject_t
        return hobject_t(pool=1, name=name)

    def payload(self, n):
        return np.frombuffer(self.rng.bytes(n), dtype=np.uint8)

    def submit(self, name, off, data):
        from ceph_tpu_torch.osd.ec_transaction import PGTransaction
        from ceph_tpu_torch.osd.types import eversion_t
        txn = PGTransaction()
        txn.write(self.oid(name), off, data)
        self.version += 1
        self.be.submit_transaction(txn, eversion_t(1, self.version),
                                   lambda v=self.version: self.acks.append(v))
        cur = self.expect.get(name)
        if cur is None and off == 0:
            self.expect[name] = data     # payloads are never mutated
            return
        cur = np.zeros(0, dtype=np.uint8) if cur is None else cur
        new = np.zeros(max(cur.size, off + data.size), dtype=np.uint8)
        new[:cur.size] = cur
        new[off:off + data.size] = data
        self.expect[name] = new

    def check_readback(self, names=None):
        for name in names or self.expect:
            got = self.be.read(self.oid(name))
            if got.shape != self.expect[name].shape or \
                    not np.array_equal(got, self.expect[name]):
                raise AssertionError(f"read back of {name} differs")


def check_parity(codec, sinfo, store, shards, w, name) -> None:
    """Every shard of one object against the host GF(2^8) encode."""
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.osd import ec_transaction as ect
    from ceph_tpu_torch.osd import ec_util
    host = ec_util.encode(sinfo, codec, w.expect[name])
    ref = gf.gf_matvec(codec.matrix[K:], host[:K])
    for s in range(K + M):
        stored = store.read(shards.cids[s], ect.shard_oid(w.oid(name), s))
        want = host[s] if s < K else ref[s - K]
        if not np.array_equal(stored, want):
            raise AssertionError(f"shard {s} of {name} differs from the host "
                                 "reference encode")


def check_crcs(store, shards, w) -> int:
    """Every valid HashInfo crc against the host crc32c of the stored
    shard bytes; returns how many objects carried one."""
    from ceph_tpu_torch.common import crc32c
    from ceph_tpu_torch.osd import ec_transaction as ect
    n_crc = 0
    for name in w.expect:
        hinfo = shards.get_hinfo(0, w.oid(name))
        if not hinfo.crc_valid:
            continue
        rows = np.stack([store.read(shards.cids[s],
                                    ect.shard_oid(w.oid(name), s))
                         for s in range(K + M)])
        if crc32c.crc32c_rows(rows, [0xFFFFFFFF] * (K + M)) != \
                list(hinfo.cumulative_shard_hashes):
            raise AssertionError(f"HashInfo crc of {name} differs from the "
                                 "host crc32c of its shards")
        n_crc += 1
    return n_crc


def degraded_reads(be, shards, w, names) -> tuple[int, float]:
    """Read `names` with shards 0 and 1 failing (K1 decode), then every
    other object healthy; returns (bytes read degraded, seconds)."""
    shards.down = {0, 1}
    t0 = time.perf_counter()
    nread = 0
    for name in names:
        got = be.read(w.oid(name))
        nread += got.size
        if not np.array_equal(got, w.expect[name]):
            raise AssertionError(f"degraded read of {name} differs")
    t_deg = time.perf_counter() - t0
    w.check_readback([n for n in w.expect if n not in names])
    torch.cuda.synchronize()
    shards.down = set()
    return nread, t_deg


def check_drained(be) -> None:
    if len(be.extent_cache) or be._projected or be._inflight:
        raise AssertionError("pipeline state did not drain")


def phase_main_path(dev, rng, combine: str, n_big: int):
    """The port's write and degraded-read path, k=8 m=3, at the pinned
    `combine`; returns (per-phase launch counts, throughput dict)."""
    from ceph_tpu_torch.ops import bitsliced as bs

    stages = StageTimes()
    codec, sinfo, store, shards, be = make_backend(dev, stages)
    point = codec.fused_point()
    if point["combine"] != combine:
        raise AssertionError(f"pinned point not read: {point}")
    # every fused result's (tail width, body, run width)
    fused = []
    real_finalize = codec.encode_extents_with_crc_finalize

    def finalize(handle):
        res = real_finalize(handle)
        fused.extend((r[2].shape[1], r[3], r[0].shape[1]) for r in res)
        return res
    codec.encode_extents_with_crc_finalize = finalize
    w = Writer(be, rng)
    big = {f"big{i}": w.payload(BIG) for i in range(n_big)}
    small = {f"small{i}": w.payload(SMALL) for i in range(N_SMALL)}
    mixed = {f"mixbig{i}": w.payload(BIG) for i in range(2)}
    mixed.update({f"mixsmall{i}": w.payload(SMALL) for i in range(4)})
    torch.cuda.synchronize()

    counts = {}
    # -- write path ---------------------------------------------------
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    with be.pipeline():
        for name, p in big.items():
            w.submit(name, 0, p)
    t_big = time.perf_counter() - t0
    write_stages = dict(stages.t)
    paths = {"big": be.fused_path}

    # device busy share over a steady window of 8 more 4 MiB writes; the
    # wall clock runs inside the profiled region, so the profiler's own
    # start-up is not counted
    window_data = {f"prof{i}": w.payload(BIG) for i in range(8)}
    win = {}

    def window():
        t0 = time.perf_counter()
        with be.pipeline():
            for name, p in window_data.items():
                w.submit(name, 0, p)
        torch.cuda.synchronize()
        win["s"] = time.perf_counter() - t0
    evs = device_events(window)
    t_win = win["s"]
    busy_ms = sum(us for _, us in evs) / 1e3
    kernel_ms = sum(us for name, us in evs
                    if "Memcpy" not in name and "Memset" not in name) / 1e3
    with be.pipeline():
        for name, p in small.items():
            w.submit(name, 0, p)
    paths["small"] = be.fused_path
    launches_before = be.batched_launches
    with be.batch():
        for name, p in mixed.items():
            w.submit(name, 0, p)
    paths["mixed"] = be.fused_path
    if be.batched_launches != launches_before + 1:
        raise AssertionError("the mixed batch did not drain as one launch")
    with be.pipeline():
        for i in range(N_RMW):
            w.submit(f"big{i}", (1 << 20) + 1000 + 4096 * i,
                     w.payload(RMW_LEN))
    torch.cuda.synchronize()
    counts[f"{combine}_write"] = bs.launch_counts()
    if w.acks != list(range(1, w.version + 1)):
        raise AssertionError("acks out of order or missing")
    hier = "hier_acc" if combine == "kernel" else "hier_lsub"
    if paths != {"big": hier, "small": "w32_flat",
                 "mixed": f"{hier}+w32_flat"}:
        raise AssertionError(f"unexpected kernel paths {paths}")
    n_fused = n_big + 8 + N_SMALL + len(mixed)
    if len(fused) != n_fused or \
            any(tail or body != width for tail, body, width in fused):
        raise AssertionError(f"fused results with a tail, or missing: "
                             f"{len(fused)} of {n_fused}")

    w.check_readback()
    check_parity(codec, sinfo, store, shards, w, f"big{n_big - 1}")
    n_crc = check_crcs(store, shards, w)
    if n_crc < n_big - N_RMW + 8 + N_SMALL + len(mixed):
        raise AssertionError(f"only {n_crc} objects carry a valid crc")

    # -- degraded read path -------------------------------------------
    bs.reset_launch_counts()
    nread, t_deg = degraded_reads(be, shards, w, big)
    counts[f"{combine}_read"] = bs.launch_counts()
    check_drained(be)
    perf = {"point": point,
            "write_4MiB_objects_GBps": n_big * BIG / t_big / 1e9,
            "write_4MiB_objects_s": t_big, "write_4MiB_objects": n_big,
            "write_stage_s": write_stages,
            "window_wall_ms": t_win * 1e3,
            "window_device_busy_ms": busy_ms,
            "window_device_kernel_ms": kernel_ms,
            "window_device_busy_share": busy_ms / (t_win * 1e3),
            "degraded_read_4MiB_objects_GBps": nread / t_deg / 1e9,
            "degraded_read_4MiB_objects_s": t_deg,
            "objects": len(w.expect), "crc_checked_objects": n_crc,
            "fused_results_tail_free": len(fused), "paths": paths}
    return counts, perf


def phase_bytes_path(dev, rng) -> tuple[dict, dict]:
    """Phase D: the write path on the byte branch (codec._use_w32 =
    False): every drain one launch of K2's byte entry at 2 KiB tiles,
    path "bytes", the operating point never consulted.  16 x 4 MiB and
    16 x 64 KiB in pipeline windows, one mixed batch(), then readback,
    degraded reads with shards 0 and 1 down, parity and HashInfo
    checks.  Returns (launch counts of the writes, throughput dict)."""
    from ceph_tpu_torch.ops import bitsliced as bs

    stages = StageTimes()
    codec, sinfo, store, shards, be = make_backend(dev, stages)
    codec._use_w32 = False
    w = Writer(be, rng)
    big = {f"bbig{i}": w.payload(BIG) for i in range(N_BIG_BYTES)}
    small = {f"bsmall{i}": w.payload(SMALL) for i in range(N_SMALL)}
    mixed = {f"bmixbig{i}": w.payload(BIG) for i in range(2)}
    mixed.update({f"bmixsmall{i}": w.payload(SMALL) for i in range(4)})
    paths = set()
    real_submit = codec.encode_extents_with_crc_submit

    def submit(runs):
        handle = real_submit(runs)
        paths.add(handle["path"])
        return handle
    codec.encode_extents_with_crc_submit = submit
    torch.cuda.synchronize()
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    with be.pipeline():
        for name, p in big.items():
            w.submit(name, 0, p)
    t_big = time.perf_counter() - t0
    write_stages = dict(stages.t)
    with be.pipeline():
        for name, p in small.items():
            w.submit(name, 0, p)
    with be.batch():
        for name, p in mixed.items():
            w.submit(name, 0, p)
    torch.cuda.synchronize()
    counts = bs.launch_counts()
    if paths != {"bytes"} or codec._fused_point is not None:
        raise AssertionError(f"byte branch took {paths}, point "
                             f"{codec._fused_point}")
    others = {n: c for n, c in counts.items()
              if n in ("fused_hier_call", "gf_encode_with_crc_w32",
                       "fused_hier_acc_call") and c}
    if counts["gf_encode_with_crc"] <= 0 or others:
        raise AssertionError(f"byte branch launches {counts}")
    drains = stages.n.get("ec_fused_fallback_drains", 0)
    if drains <= 0 or stages.n.get("ec_fused_kernel_drains", 0):
        raise AssertionError(f"byte drains not counted as fallback: "
                             f"{stages.n}")
    w.check_readback()
    check_parity(codec, sinfo, store, shards, w, f"bbig{N_BIG_BYTES - 1}")
    n_crc = check_crcs(store, shards, w)
    if n_crc != len(w.expect):
        raise AssertionError(f"only {n_crc} of {len(w.expect)} objects "
                             "carry a valid crc")
    nread, t_deg = degraded_reads(be, shards, w, big)
    check_drained(be)
    return counts, {
        "write_4MiB_objects_GBps": len(big) * BIG / t_big / 1e9,
        "write_4MiB_objects_s": t_big, "write_4MiB_objects": len(big),
        "write_stage_s": write_stages,
        "degraded_read_4MiB_objects_GBps": nread / t_deg / 1e9,
        "objects": len(w.expect), "crc_checked_objects": n_crc,
        "fallback_drains": drains, "paths": sorted(paths)}


def phase_w32_sweep() -> tuple[dict, list[dict]]:
    """Phase E: tools/w32_sweep at full size (4 MiB a chunk), K1 and
    K4 over tiles 64 KiB - 4 MiB; every row exact, none with an error.
    Returns (launch counts of the sweep, its rows)."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.tools import w32_sweep

    torch.cuda.synchronize()
    bs.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = w32_sweep.sweep(w32_sweep.parse_args([]))
    torch.cuda.synchronize()
    counts = bs.launch_counts()
    if len(rows) != 2 * len(w32_sweep.TILES) or any(
            "error" in r or not r["exact"] for r in rows):
        raise AssertionError(f"w32_sweep rows failed: {rows}")
    for r in rows:
        print(f"# w32_sweep stream={r['stream']!s:5} tile={r['tile']:8d} "
              f"exact={r['exact']} GB/s={r.get('gbps')}", flush=True)
    return counts, rows


def k1_thread_bytes_table(dev, rng) -> list[dict]:
    """K1 at 4 and 16 bytes of each row a thread and at k1_launch's pick,
    and K4 forced to 1, 2, 4 and 8 passes of the 8 source rows (the
    multi-pass path at #7's own shape), over widths of 16 KiB - 4 MiB a
    row (8 -> 3, the write path's Cauchy code; 256 and 512 KiB sit
    either side of k1_launch's threshold), each at its default grid.  Each entry
    checked against K1's plain version, then timed as the kernel rows
    are (graph replays)."""
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    enc = bs.tables_tensor(gf.product_tables(gf.cauchy_rs_matrix(K, M)[K:]),
                           dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    table = []
    for width in (16 << 10, 128 << 10, 256 << 10, 512 << 10, 4 << 20):
        data = torch.from_numpy(
            rng.integers(0, 256, (K, width), dtype=np.uint8)).to(dev)
        want = bs.gf_bitmatmul_plain(enc, data)
        pick = bs.k1_launch(width, K, M, sms)
        print(f"# k1_launch row={width:8d} B  picks {pick[0]} bytes a "
              f"thread, {pick[1]} blocks", flush=True)
        variants = [(f"K1 {tb} B", tb, lambda tb=tb: bs.gf_bitmatmul(
            enc, data, thread_bytes=tb)) for tb in (4, 16)]
        variants.append(("K1 pick", pick[0],
                         lambda: bs.gf_bitmatmul(enc, data)))
        variants += [(f"K4 P={g}", None, lambda g=g: bs.gf_bitmatmul_stream(
            enc, data, groups=g)) for g in (1, 2, 4, 8)]
        for name, tb, fn in variants:
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name} at {width} B differs")
            us = graph_event_ms(fn) * 1e3
            row = {"kernel": name, "row_bytes": width, "us": us,
                   "GBps": K * width / us / 1e3}
            if tb is not None:
                row["thread_bytes"] = tb
                row["blocks"] = bs.k1_launch(width, K, M, sms,
                                             thread_bytes=tb)[1]
            table.append(row)
            print(f"# k1_table {name:8s} row={width:8d} B  {us:9.3f} us  "
                  f"{K * width / us / 1e3:8.1f} GB/s", flush=True)
    return table


def phase_ab() -> dict:
    """Phase F: the CPU plugins with the native library, and
    ec_benchmark --ab (isa against torch, per call and batch 32), then
    -p isa and -p jerasure with the reference's canonical invocation."""
    from ceph_tpu_torch.common import native
    from ceph_tpu_torch.tools import ec_benchmark

    if not native.available():
        raise AssertionError("the native CPU library did not build")

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ec_benchmark.main(argv)
        if rc != 0:
            raise AssertionError(f"ec_benchmark {argv} exited {rc}")
        print(f"# ec_benchmark {' '.join(argv)}", flush=True)
        return buf.getvalue().strip().splitlines()

    ab = [json.loads(line) for line in run(
        ["--ab", "-P", f"k={K}", "-P", f"m={M}", "-S", "1048576",
         "--batch", "32", "--min-time", "1"])]
    sides = {(r["side"], r["mode"]) for r in ab if "side" in r}
    ratios = {r["ratio_mode"]: r["torch_over_cpu"] for r in ab
              if "ratio_mode" in r}
    if sides != {(s, m) for s in ("isa", "torch")
                 for m in ("per_call", "batched")} or \
            set(ratios) != {"per_call", "batched"}:
        raise AssertionError(f"--ab rows incomplete: {ab}")
    for r in ab:
        print(f"# {json.dumps(r)}", flush=True)
    cpu = {}
    for plugin in ("isa", "jerasure"):
        (line,) = run(["-p", plugin, "-P", f"k={K}", "-P", f"m={M}",
                       "-S", "1048576", "-i", "1000"])
        sec, kib = line.split("\t")
        cpu[plugin] = {"line": line,
                       "GBps": int(kib) * 1024 / float(sec) / 1e9}
        print(f"{line}\t# {cpu[plugin]['GBps']:.3f} GB/s", flush=True)
    return {"ab": ab, "cpu_plugins": cpu}


def phase_sweep(dev, cache_file) -> dict:
    """Phase A: the autotune sweep on the card with a fresh cache, then a
    second plugin init that must read the cached row with no
    measurement."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import autotune

    os.environ["CEPH_TPU_AUTOTUNE_CACHE"] = str(cache_file)
    reg = ErasureCodePluginRegistry.instance()
    prof = {"k": str(K), "m": str(M), "device": str(dev)}
    codec = reg.factory("torch", prof)
    measured = []
    real = autotune._measure

    def counting(tables, k, m, cand):
        measured.append(cand)
        return real(tables, k, m, cand)
    autotune._measure = counting
    try:
        report = []
        t0 = time.perf_counter()
        best = autotune.fused_operating_point(
            K, M, tables=codec._enc_tables, mat=codec.matrix[K:],
            report=report)
        t_sweep = time.perf_counter() - t0
        n_sweep = len(measured)
        again = reg.factory("torch", prof).fused_point()
        n_again = len(measured) - n_sweep
    finally:
        autotune._measure = real
    table = [{"wb": c["wb"], "combine": c["combine"], "valid": r is not None,
              "GBps": None if r is None else r / 1e9} for c, r in report]
    for row in table:
        print(f"# sweep wb={row['wb']:5d} combine={row['combine']:6s} "
              f"valid={row['valid']} GB/s={row['GBps']}", flush=True)
    if len(table) != 6 or not all(row["valid"] for row in table):
        raise AssertionError(f"sweep table incomplete or invalid: {table}")
    key = autotune._device_key(dev, K, M)
    entry = autotune._load_cache()["entries"].get(key)
    maj, mnr = torch.cuda.get_device_capability(dev)
    for part in (torch.cuda.get_device_name(dev), f"/sm{maj}{mnr}/",
                 f"/torch{torch.__version__}/", f"/{autotune.KERNEL_GEN}/"):
        if part not in key:
            raise AssertionError(f"cache key {key!r} lacks {part!r}")
    if entry is None or {kk: entry[kk] for kk in best} != best:
        raise AssertionError(f"cache row {entry} is not the winner {best}")
    if again != best or n_again:
        raise AssertionError(f"second init measured {n_again} times or "
                             f"picked {again} instead of {best}")
    return {"best": best, "table": table, "sweep_s": t_sweep,
            "measurements": n_sweep, "cache_key": key,
            "second_init_measurements": n_again}


def write_round(dev, rng, n: int, tag: str) -> dict:
    """n x 4 MiB writes in one pipeline window on a fresh backend whose
    codec reads its point from the current autotune cache; every object
    read back."""
    stages = StageTimes()
    codec, _, _, _, be = make_backend(dev, stages)
    point = codec.fused_point()
    w = Writer(be, rng)
    data = {f"{tag}{i}": w.payload(BIG) for i in range(n)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with be.pipeline():
        for name, p in data.items():
            w.submit(name, 0, p)
    t = time.perf_counter() - t0
    w.check_readback()
    return {"point": point, "path": be.fused_path,
            "write_4MiB_objects_GBps": n * BIG / t / 1e9,
            "write_4MiB_objects_s": t, "write_4MiB_objects": n,
            "write_stage_s": stages.t}


def phase_write_ab(dev, rng, tmp, best: dict) -> dict:
    """The write path at the point the sweep picked (read from the
    sweep's cache), then an interleaved A/B of the two combines, each
    pinned through its own cache file, in the order xla, kernel,
    kernel, xla, xla, kernel — so drift of the shared host cancels."""
    from ceph_tpu_torch.ops import autotune
    os.environ["CEPH_TPU_AUTOTUNE_CACHE"] = str(tmp / "sweep.json")
    picked = write_round(dev, rng, N_BIG_PICK, "pick")
    if picked["point"] != best:
        raise AssertionError(f"{picked['point']} is not the swept point "
                             f"{best}")
    rounds = {"xla": [], "kernel": []}
    for combine in ("xla", "kernel", "kernel", "xla", "xla", "kernel"):
        pin_point(tmp / f"ab_{combine}.json", dev,
                  dict(autotune.default_point(), combine=combine))
        res = write_round(dev, rng, N_BIG_PICK, "ab")
        want = "hier_acc" if combine == "kernel" else "hier_lsub"
        if res["path"] != want:
            raise AssertionError(f"A/B round at {combine} took {res['path']}")
        rounds[combine].append(res["write_4MiB_objects_GBps"])
    return {"at_swept_point": picked, "ab_GBps": rounds,
            "ab_median_GBps": {c: statistics.median(v)
                               for c, v in rounds.items()}}


def phase_benchmark():
    """Phase C: the ec_benchmark CLI on the card; returns (launch counts
    of the two encode invocations, of the two decode invocations, one
    dict per invocation)."""
    from ceph_tpu_torch.ec.plugins import ec_torch
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.tools import ec_benchmark

    base = ["-p", "torch", "-P", f"k={K}", "-P", f"m={M}",
            "-S", "1048576", "-i", "1000"]
    invocations = [base, base + ["--batch", "32"],
                   base + ["-w", "decode", "-e", "1"],
                   base + ["-w", "decode", "-e", "2", "-E", "exhaustive"]]
    erasure_sets = set()
    real = ec_torch.ErasureCodeTorch.decode_chunks

    def spy(self, dense, erasures):
        erasure_sets.add(tuple(sorted(erasures)))
        return real(self, dense, erasures)
    out = []
    counts = []
    ec_torch.ErasureCodeTorch.decode_chunks = spy
    try:
        for i, argv in enumerate(invocations):
            if i in (0, 2):         # counts of the encode, then decode pair
                torch.cuda.synchronize()
                bs.reset_launch_counts()
            erasure_sets.clear()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = ec_benchmark.main(argv)
            if rc != 0:
                raise AssertionError(f"ec_benchmark {argv} exited {rc}")
            line = buf.getvalue().strip().splitlines()[-1]
            sec, kib = line.split("\t")
            gbps = int(kib) * 1024 / float(sec) / 1e9
            print(f"# ec_benchmark {' '.join(argv)}", flush=True)
            print(f"{line}\t# {gbps:.3f} GB/s", flush=True)
            out.append({"args": " ".join(argv), "line": line,
                        "seconds": float(sec), "KiB": int(kib),
                        "GBps": gbps,
                        "erasure_sets_verified": len(erasure_sets)})
            if i in (1, 3):
                torch.cuda.synchronize()
                counts.append(bs.launch_counts())
    finally:
        ec_torch.ErasureCodeTorch.decode_chunks = real
    if out[3]["erasure_sets_verified"] != 55 or \
            out[2]["erasure_sets_verified"] != 1:
        raise AssertionError(f"decode verified {out[3]} / {out[2]}")
    if counts[1]["gf_bitmatmul"] <= 0:
        raise AssertionError("the decode workload launched no K1")
    return counts[0], counts[1], out


# Phase L: the cluster on the card.  A mon and 13 OSD daemons in one
# process (tools/vstart.Cluster) over the loopback messenger, MemStore,
# auth none, every daemon's codecs and launch queue on the card, the boot
# prewarm on and the kernel library cache in a directory of the run's own.
# Pool A is ISA-L's canonical profile on the torch plugin (BASELINE.json's
# write path), pool B BASELINE.json's CLAY profile; 13 OSDs let both remap
# around one lost OSD (pool B spans 12).  Objects are RBD's 4 MiB, written
# and read 16 at a time (rados bench's default concurrency), as few as
# keep the whole script in its time: phase Q's Q3 and Q4 repeat the
# writes and degraded reads on 12 OSDs (PERF.md section 4).
N_CLUSTER_OSDS = 13
CLUSTER_POOLS = (
    ("poola", {"plugin": "torch", "k": str(K), "m": str(M),
               "technique": "cauchy", "stripe_unit": str(STRIPE_UNIT)}, 16),
    ("poolb", {"plugin": "clay", "k": "8", "m": "4", "d": "11"}, 8))
N_CLUSTER_OBJECTS = {"poola": 16, "poolb": 8}
CLUSTER_OBJECT = BIG
N_CLUSTER_RMW = 16
CLUSTER_RMW_LEN = SMALL
CLUSTER_DEPTH = 16
CLUSTER_VICTIM = 5
CLUSTER_PREWARM = True
CLUSTER_CHILD_TIMEOUT_S = 900
CLUSTER_CLEAN_TIMEOUT_S = 600.0
CLUSTER_ASOK_TIMEOUT_S = 600.0


def _windowed(submits, depth: int) -> None:
    """Run the aio submits with at most `depth` in flight."""
    inflight = []
    for submit in submits:
        if len(inflight) >= depth:
            inflight.pop(0).result(timeout=300)
        inflight.append(submit())
    for fut in inflight:
        fut.result(timeout=300)


def cluster_shard_crcs(osds) -> dict:
    """Every shard on every live OSD's store against its integrity
    xattr (store_shard_crcs)."""
    return store_shard_crcs({osd.osd_id: osd.store for osd in osds
                             if osd is not None})


def store_shard_crcs(stores: dict) -> dict:
    """Every shard in each store of {osd id: store} against its
    integrity xattr: a valid HashInfo's cumulative crc, or the
    chunk_crc of an object in overwrite mode, must equal the host
    crc32c of the shard's bytes.  Returns the counts checked."""
    from ceph_tpu_torch.common import crc32c as host_crc
    from ceph_tpu_torch.osd.ec_util import (CHUNK_CRC_KEY, HINFO_KEY,
                                            HashInfo)
    out = {"hinfo": 0, "chunk_crc": 0}
    for osd_id, store in stores.items():
        for cid in store.list_collections():
            for oid in store.list_objects(cid):
                attrs = store.getattrs(cid, oid)
                if HINFO_KEY not in attrs:
                    continue
                data = bytes(store.read(cid, oid))
                got = host_crc.crc32c(data, 0xFFFFFFFF)
                h = HashInfo.decode(attrs[HINFO_KEY])
                if not h.invalidated:
                    want = h.cumulative_shard_hashes[cid.shard]
                    kind = "hinfo"
                    if len(data) != h.total_chunk_size:
                        raise AssertionError(
                            f"osd.{osd_id} {cid} {oid}: {len(data)} "
                            f"bytes, HashInfo says {h.total_chunk_size}")
                elif CHUNK_CRC_KEY in attrs:
                    want = int.from_bytes(attrs[CHUNK_CRC_KEY], "little")
                    kind = "chunk_crc"
                else:
                    continue
                if got != want:
                    raise AssertionError(
                        f"osd.{osd_id} {cid} {oid}: crc32c {got:#x}, "
                        f"its {kind} says {want:#x}")
                out[kind] += 1
    return out


def cluster_run(device: str, cache_dir: str, asok_dir: str) -> dict:
    """Phase L's traffic on one cluster: write, RMW and read pool A,
    write and read pool B, lose an OSD (down: degraded reads of both
    pools; out: recovery to active+clean), then a deep scrub through
    every OSD's admin socket.  Every read must equal what was written,
    every shard its HashInfo or chunk crc, the scrub find nothing.
    Launch counts are zeroed once after boot and read at each step's
    end (deltas) and after the last."""
    from ceph_tpu_torch.common.admin_socket import admin_command
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.ops.profiler import device_profiler
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.tools.vstart import Cluster
    rng = np.random.default_rng(SEED)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def asok(osd_id, cmd, timeout=30.0):
        return admin_command(f"{asok_dir}/osd.{osd_id}.asok", cmd,
                             timeout=timeout)

    report = {"osds": N_CLUSTER_OSDS, "victim": CLUSTER_VICTIM,
              "steps": {}, "launches": {}}
    t0 = time.perf_counter()
    c = Cluster(n_osds=N_CLUSTER_OSDS, device=device,
                prewarm=CLUSTER_PREWARM, compile_cache_dir=cache_dir,
                asok_dir=asok_dir)
    with c:
        report["boot_s"] = time.perf_counter() - t0
        # the boot statuses through the admin socket: the reference's
        # daemon keeps booting when the cache or the prewarm fails, so
        # the run must read them
        pw = asok(0, {"prefix": "prewarm status"})
        ledger = asok(0, {"prefix": "compile ledger"})
        cache = pw["persistent_cache"]
        if "error" in (pw.get("boot") or {}) or "error" in cache or \
                not cache["enabled"] or "error" in ledger:
            raise AssertionError(f"cluster boot: prewarm {pw.get('boot')}, "
                                 f"cache {cache}, ledger error "
                                 f"{ledger.get('error')}")
        if CLUSTER_PREWARM and not (pw["boot"] or {}).get("planned"):
            raise AssertionError(f"cluster boot prewarm ran nothing: {pw}")
        report["prewarm"] = {k: v for k, v in (pw["boot"] or {}).items()
                             if k != "buckets"}
        report["compile_cache"] = cache
        cl = c.client()
        ios, pool_ids = {}, {}
        for name, profile, pg_num in CLUSTER_POOLS:
            cl.set_ec_profile(name, profile)
            cl.create_pool(name, "erasure", erasure_code_profile=name,
                           pg_num=pg_num)
            ios[name] = cl.open_ioctx(name)
            pool_ids[name] = ios[name].pool_id
        expect = {(pool, f"{pool}.{i}"): rng.integers(
            0, 256, CLUSTER_OBJECT, dtype=np.uint8)
            for pool, n in N_CLUSTER_OBJECTS.items() for i in range(n)}
        prof = device_profiler()
        sync()
        bs.reset_launch_counts()
        narrow0 = bs._encode_crc_launch.narrow_launches
        kinds0 = dict(prof.profile(last=0)["by_kind"])
        last = {"counts": bs.launch_counts()}

        def step(label, fn, nbytes):
            t = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t
            now = bs.launch_counts()
            report["launches"][label] = {
                k: now[k] - last["counts"][k] for k in now}
            last["counts"] = now
            report["steps"][label] = {"wall_s": wall, "bytes": nbytes,
                                      "GBps": nbytes / wall / 1e9}

        def write(pool):
            _windowed([lambda key=key: ios[key[0]].aio_write_full(
                key[1], expect[key].tobytes())
                for key in expect if key[0] == pool], CLUSTER_DEPTH)

        def read_all(what):
            futs = {}
            keys = list(expect)

            def submit(key):
                fut = ios[key[0]].aio_read(key[1], CLUSTER_OBJECT)
                futs[key] = fut
                return fut
            _windowed([lambda key=key: submit(key) for key in keys],
                      CLUSTER_DEPTH)
            for key in keys:
                got = futs[key].result(timeout=300)
                if got != expect[key].tobytes():
                    raise AssertionError(f"{what}: {key[1]} read back "
                                         f"wrong")

        pool_bytes = {p: n * CLUSTER_OBJECT
                      for p, n in N_CLUSTER_OBJECTS.items()}
        step("write_a", lambda: write("poola"), pool_bytes["poola"])
        # every pool-A PG that took objects: its primary's backend
        # drained them (ec_drain_submits, the ec.<pgid> perf set)
        osdmap = c.mon.osdmap
        from ceph_tpu_torch.osd.types import pg_t
        drains = {}
        for pool, name in expect:
            if pool != "poola":
                continue
            seed = osdmap.object_to_pg(pool_ids[pool], name).seed
            pgid = pg_t(pool_ids[pool], seed)
            primary = osdmap.pg_to_up_acting_osds(pgid)[3]
            perf = c.osds[primary].cct.perf.dump().get(f"ec.{pgid}", {})
            drains[str(pgid)] = int(perf.get("ec_drain_submits", 0))
        if not drains or min(drains.values()) <= 0:
            raise AssertionError(f"pool A primaries without drains: "
                                 f"{drains}")
        report["pool_a_drain_submits"] = drains

        rmw = []
        names_a = [name for pool, name in expect if pool == "poola"]
        for i in rng.choice(len(names_a), N_CLUSTER_RMW, replace=False):
            off = int(rng.integers(0, CLUSTER_OBJECT - CLUSTER_RMW_LEN))
            patch = rng.integers(0, 256, CLUSTER_RMW_LEN, dtype=np.uint8)
            expect[("poola", names_a[i])][off:off + CLUSTER_RMW_LEN] = patch
            rmw.append((names_a[i], off, patch.tobytes()))

        def overwrite():
            # a partial write on the client's aio pool, as aio_write_full
            io = ios["poola"]
            _windowed([lambda r=r: io.client._pool.submit(
                io.write, r[0], r[2], r[1]) for r in rmw], CLUSTER_DEPTH)
        step("rmw_a", overwrite, N_CLUSTER_RMW * CLUSTER_RMW_LEN)
        step("write_b", lambda: write("poolb"), pool_bytes["poolb"])
        all_bytes = sum(pool_bytes.values())
        step("read", lambda: read_all("read"), all_bytes)

        # lose one OSD: down (degraded reads), then out (recovery)
        c.remove_osd(CLUSTER_VICTIM)
        c.mark_osd_down(CLUSTER_VICTIM)
        epoch = c.mon.osdmap.epoch
        deadline = time.time() + 30
        while any(o is not None and o.osdmap.epoch < epoch for o in c.osds):
            if time.time() > deadline:
                raise AssertionError("the down map did not reach the OSDs")
            time.sleep(0.05)
        step("degraded_read", lambda: read_all("degraded read"), all_bytes)

        def pushed():
            return sum(int(o.cct.perf.dump().get(f"osd.{o.osd_id}", {})
                           .get("recovery_pushed_bytes", 0))
                       for o in c.osds if o is not None)
        pushed0 = pushed()

        def recover():
            r, out = cl.mon_command({"prefix": "osd out",
                                     "id": CLUSTER_VICTIM})
            if r != 0:
                raise AssertionError(f"osd out: {r} {out}")
            deadline = time.time() + CLUSTER_CLEAN_TIMEOUT_S
            while not c._active_clean_once()[0]:
                if time.time() > deadline:
                    raise AssertionError(
                        f"no active+clean: {c._active_clean_once()[1]}")
                time.sleep(0.05)
        step("recovery", recover, 0)
        c.wait_active_clean(timeout=CLUSTER_CLEAN_TIMEOUT_S)
        rebuilt = pushed() - pushed0
        rec = report["steps"]["recovery"]
        rec["bytes"] = rebuilt
        rec["GBps"] = rebuilt / rec["wall_s"] / 1e9
        if rebuilt <= 0:
            raise AssertionError("recovery pushed no shard bytes")
        step("read_after_recovery", lambda: read_all("read after recovery"),
             all_bytes)

        scrub = {"pgs": 0, "objects": 0, "errors": [], "device_bytes": 0,
                 "host_bytes": 0}

        def deep_scrub():
            for osd in c.osds:
                if osd is None:
                    continue
                res = asok(osd.osd_id, {"prefix": "scrub", "deep": True},
                           timeout=CLUSTER_ASOK_TIMEOUT_S)
                if "error" in res:
                    raise AssertionError(f"osd.{osd.osd_id} scrub: {res}")
                for pg, r in res.items():
                    scrub["pgs"] += 1
                    scrub["objects"] += r["objects"]
                    scrub["errors"] += r["errors"]
                    scrub["device_bytes"] += r.get("device_bytes", 0)
                    scrub["host_bytes"] += r.get("host_bytes", 0)
        step("deep_scrub", deep_scrub, 0)
        st = report["steps"]["deep_scrub"]
        st["bytes"] = scrub["device_bytes"] + scrub["host_bytes"]
        st["GBps"] = st["bytes"] / st["wall_s"] / 1e9
        report["scrub"] = scrub
        if scrub["errors"] or scrub["objects"] != len(expect):
            raise AssertionError(f"deep scrub: {scrub}")
        if on_card and scrub["device_bytes"] <= 0:
            raise AssertionError(f"deep scrub ran no device bytes: {scrub}")
        report["launch_totals"] = bs.launch_counts()
        report["narrow_launches"] = \
            bs._encode_crc_launch.narrow_launches - narrow0
        kinds = prof.profile(last=0)["by_kind"]
        report["profiler_by_kind"] = {
            k: v - kinds0.get(k, 0) for k, v in kinds.items()}
        queue = ECLaunchQueue.host_get()
        report["launch_queue"] = queue.status() if queue else None
        report["shard_crcs"] = cluster_shard_crcs(c.osds)
        if not report["shard_crcs"]["hinfo"]:
            raise AssertionError("no HashInfo crc was checked")
    return report


def cluster_child(cache_dir: str, asok_dir: str) -> int:
    """Phase L in its own process: the kernel library cache must be
    pointed at `cache_dir` before the library's first load, which the
    parent has long made.  Prints one JSON line."""
    from ceph_tpu_torch.ops import compile_cache
    report = cluster_run("cuda", cache_dir, asok_dir)
    report["compile_cache_after"] = compile_cache.status()
    print(json.dumps(report), flush=True)
    return 0


def phase_cluster(tmp) -> tuple[dict, dict]:
    """Phase L: the cluster in a fresh process whose kernel library
    cache holds the library the parent built (a restarted daemon's
    load).  Returns (the phase's launch counts, the report)."""
    from ceph_tpu_torch.ops import _build
    cache_dir = tmp / "cluster_cache"
    asok_dir = tmp / "asok"
    cache_dir.mkdir()
    asok_dir.mkdir()
    shutil.copy2(_build.library_path(), cache_dir)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--cluster-child",
         str(cache_dir), str(asok_dir)],
        capture_output=True, text=True, timeout=CLUSTER_CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"cluster exited {proc.returncode}:\n"
                             f"{proc.stderr[-6000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    lib = res["compile_cache_after"]["kernel_library"]
    if lib["builds_in_process"] or not res["compile_cache_after"]["enabled"]:
        raise AssertionError(f"the cluster did not load the cached "
                             f"library: {res['compile_cache_after']}")
    total = res["launch_totals"]
    missing = [k for k in ("gf_bitmatmul", "gf_bitmatmul_stream",
                           "crc32c_rows_l") if total[k] <= 0]
    fused = total["fused_hier_acc_call"] + total["fused_hier_call"] + \
        total["gf_encode_with_crc_w32"]
    if missing or fused <= 0:
        raise AssertionError(f"phase L missed kernels {missing} (fused "
                             f"{fused}): {total}")
    res["card"] = nvidia_smi_line()
    steps = res["steps"]
    print(f"# cluster ({res['card']}): boot {res['boot_s']:.2f} s; "
          + "; ".join(f"{k} {v['GBps']:.4f} GB/s ({v['wall_s']:.3f} s)"
                      for k, v in steps.items()), flush=True)
    print(f"# cluster launches {total}; by kind "
          f"{res['profiler_by_kind']}; queue {res['launch_queue']}",
          flush=True)
    return total, res


# Phase M: a cluster of processes over BlueStore (Ceph Octopus's default
# osd_objectstore).  A mon with a data dir and 12 OSD daemons, each its
# own process (tools/proc_cluster.ProcCluster -> tools/daemon_main) with
# its codecs and host launch queue on the card, the boot prewarm on, and
# the kernel library loaded from a cache directory of the run's own.
# Pool M is ISA-L's canonical k=8 m=3 on the torch plugin, its point
# pinned to K3; 12 OSDs = k+m+1, so PGs can remap.  rados bench's 4 MiB
# objects, 16 in flight.  Heartbeats are off: the run marks the killed
# OSD down itself, and 13 processes booting on the host's cores must
# not flap each other down.
N_PROC_OSDS = 12
PROC_POOL = ("poolm", {"plugin": "torch", "k": str(K), "m": str(M),
                       "technique": "cauchy",
                       "stripe_unit": str(STRIPE_UNIT)}, 16)
N_PROC_OBJECTS = 64
N_PROC_DOWN_OBJECTS = 16
PROC_OBJECT = BIG
N_PROC_RMW = 16
PROC_RMW_LEN = SMALL
PROC_DEPTH = 16
PROC_BOOT_TIMEOUT_S = 120.0
PROC_CLEAN_TIMEOUT_S = 300.0
PROC_ASOK_TIMEOUT_S = 600.0


def dir_bytes(path) -> int:
    """Bytes a directory takes on disk (allocated blocks)."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.stat(os.path.join(root, f)).st_blocks * 512
            except OSError:
                pass
    return total


def kill_shard_holder(c, io, oid: str) -> int:
    """SIGKILL the OSD that holds data shard 1 of `oid` in `io`'s pool,
    mark it down, and wait until the client's map shows it down.
    Returns the OSD."""
    objecter = io.client.objecter
    pgid = objecter._calc_target(io.pool_id, oid)[0].pgid
    victim = objecter.osdmap.pg_to_up_acting_osds(pgid)[1][1]
    c.kill_osd(victim)
    c.mark_osd_down(victim)
    deadline = time.time() + 30
    while objecter.osdmap.is_up(victim):
        if time.time() > deadline:
            raise AssertionError("the client never saw the down map")
        objecter.refresh_map(timeout=2.0)
    return victim


class ProcDaemons:
    """The OSD daemons of a process cluster, read through their admin
    sockets: `boot_check` after a daemon's boot, `read_launches` after
    a step.  Launches by the prewarm are left out."""

    def __init__(self, c, cache_dir):
        self.c, self.cache_dir = c, cache_dir
        self.base = {}       # osd -> its launch counts when last read
        self.totals = {}     # kernel -> launches in the daemons, summed

    def asok(self, osd_id, cmd, timeout=30.0):
        from ceph_tpu_torch.common.admin_socket import admin_command
        return admin_command(self.c.asok_path(f"osd.{osd_id}"), cmd,
                             timeout=timeout)

    def boot_check(self, osd_id):
        """A daemon just booted: its library came from the cache (0
        builds), its prewarm ran without an error; its counts so far
        (the prewarm's) become its baseline."""
        ledger = self.asok(osd_id, {"prefix": "compile ledger"})
        lib = ledger["kernel_library"]
        cache = ledger["persistent_cache"]
        if "error" in ledger or "error" in cache or \
                lib["builds_in_process"] or not cache["enabled"] or \
                cache["dir"] != str(self.cache_dir):
            raise AssertionError(f"osd.{osd_id} boot: library {lib}, "
                                 f"cache {cache}")
        pw = self.asok(osd_id, {"prefix": "prewarm status"})
        if "error" in (pw.get("boot") or {}) or \
                not (pw.get("boot") or {}).get("planned"):
            raise AssertionError(f"osd.{osd_id} prewarm: {pw.get('boot')}")
        self.base[osd_id] = self.asok(
            osd_id, {"prefix": "launch profile"})["kernel_launches"]

    def read_launches(self) -> dict:
        """Every running daemon's launches since its last reading."""
        step = {}
        for osd_id, proc in enumerate(self.c.osd_procs):
            if proc is None:
                continue
            now = self.asok(osd_id, {"prefix": "launch profile"})[
                "kernel_launches"]
            for k, n in now.items():
                d = n - self.base[osd_id].get(k, 0)
                step[k] = step.get(k, 0) + d
                self.totals[k] = self.totals.get(k, 0) + d
            self.base[osd_id] = now
        return step


def timed(fn, nbytes) -> dict:
    """Wall seconds, bytes and GB/s of one call of fn."""
    t = time.perf_counter()
    fn()
    wall = time.perf_counter() - t
    return {"wall_s": wall, "bytes": nbytes, "GBps": nbytes / wall / 1e9}


def proc_cluster_run(device: str, root, cache_dir) -> dict:
    """Phase M's traffic on one process cluster over BlueStore: write
    and overwrite pool M, SIGKILL an OSD that holds shards of the
    overwrites, write while it is down, read every object degraded,
    revive it to active+clean, read, SIGKILL every daemon (the mon too),
    restart them all from their data dirs to active+clean, read every
    acked object, deep-scrub through every OSD's admin socket; then stop
    the cluster and hold every shard in every OSD's BlueStore, mounted
    offline, against its HashInfo or chunk crc.  Each daemon's kernel
    launches are read through its `launch profile` after its boot
    (launches by the prewarm are left out) and before it is killed."""
    from ceph_tpu_torch.store import create_store
    from ceph_tpu_torch.tools.proc_cluster import ProcCluster
    rng = np.random.default_rng(SEED + 13)
    on_card = torch.device(device).type == "cuda"
    asok_dir = root / "asok"
    asok_dir.mkdir()
    report = {"osds": N_PROC_OSDS, "steps": {}, "launches": {}}
    c = ProcCluster(n_osds=N_PROC_OSDS, objectstore="bluestore",
                    data_dir=str(root / "data"), asok_dir=str(asok_dir),
                    heartbeat_interval=0.0, prewarm=True,
                    compile_cache_dir=str(cache_dir),
                    boot_timeout=PROC_BOOT_TIMEOUT_S, device=device)
    daemons = ProcDaemons(c, cache_dir)
    asok, boot_check = daemons.asok, daemons.boot_check

    def step(label, fn, nbytes):
        report["steps"][label] = timed(fn, nbytes)
        report["launches"][label] = daemons.read_launches()

    def pushed():
        out = 0
        for i in range(N_PROC_OSDS):
            if c.osd_procs[i] is not None:
                perf = asok(i, {"prefix": "perf dump"})
                out += int(perf.get(f"osd.{i}", {}).get(
                    "recovery_pushed_bytes", 0))
        return out

    name, profile, pg_num = PROC_POOL
    expect = {f"m{i}": rng.integers(0, 256, PROC_OBJECT, dtype=np.uint8)
              for i in range(N_PROC_OBJECTS)}
    down_expect = {f"d{i}": rng.integers(0, 256, PROC_OBJECT,
                                         dtype=np.uint8)
                   for i in range(N_PROC_DOWN_OBJECTS)}
    t0 = time.perf_counter()
    try:
        c.start()
        report["boot_s"] = time.perf_counter() - t0
        report["daemon_ready_s"] = dict(c.ready_s)
        for i in range(N_PROC_OSDS):
            boot_check(i)
        cl = c.client()
        cl.set_ec_profile(name, profile)
        cl.create_pool(name, "erasure", erasure_code_profile=name,
                       pg_num=pg_num)
        io = cl.open_ioctx(name)

        def write(objs):
            _windowed([lambda k=k, v=v: io.aio_write_full(k, v.tobytes())
                       for k, v in objs.items()], PROC_DEPTH)

        def read_all(what):
            futs = {}

            def submit(k):
                futs[k] = io.aio_read(k, PROC_OBJECT)
                return futs[k]
            _windowed([lambda k=k: submit(k) for k in expect], PROC_DEPTH)
            for k, v in expect.items():
                got = futs[k].result(timeout=300)
                if got != v.tobytes():
                    g = np.frombuffer(got, dtype=np.uint8)
                    bad = np.flatnonzero(g[:v.size] != v[:g.size])
                    raise AssertionError(
                        f"{what}: {k} read back wrong ({g.size} bytes "
                        f"of {v.size}, {bad.size} differ from "
                        f"{bad[:1].tolist()})")

        step("write", lambda: write(expect), N_PROC_OBJECTS * PROC_OBJECT)
        rmw = []
        for k in rng.choice(sorted(expect), N_PROC_RMW, replace=False):
            off = int(rng.integers(0, PROC_OBJECT - PROC_RMW_LEN))
            patch = rng.integers(0, 256, PROC_RMW_LEN, dtype=np.uint8)
            expect[k][off:off + PROC_RMW_LEN] = patch
            rmw.append((k, off, patch.tobytes()))
        step("rmw", lambda: _windowed(
            [lambda r=r: io.client._pool.submit(io.write, r[0], r[2], r[1])
             for r in rmw], PROC_DEPTH), N_PROC_RMW * PROC_RMW_LEN)

        # SIGKILL an OSD holding a data shard of the first overwrite
        t_kill = time.perf_counter()
        victim = report["victim"] = kill_shard_holder(c, io, rmw[0][0])
        step("write_down", lambda: write(down_expect),
             N_PROC_DOWN_OBJECTS * PROC_OBJECT)
        expect.update(down_expect)
        all_bytes = len(expect) * PROC_OBJECT
        step("degraded_read", lambda: read_all("degraded read"), all_bytes)
        pushed0 = pushed()

        def revive():
            c.revive_osd(victim)
            boot_check(victim)
            c.wait_active_clean(timeout=PROC_CLEAN_TIMEOUT_S)
        step("revive_to_clean", revive, 0)
        rec = report["steps"]["revive_to_clean"]
        rec["bytes"] = pushed() - pushed0
        rec["GBps"] = rec["bytes"] / rec["wall_s"] / 1e9
        rec["sigkill_to_clean_s"] = time.perf_counter() - t_kill
        if rec["bytes"] <= 0:
            raise AssertionError("the revive rebuilt no shard bytes")
        step("read_after_revive", lambda: read_all("read after revive"),
             all_bytes)

        # power loss: every daemon, the mon too
        def cold_restart():
            c.kill_all()
            t = time.perf_counter()
            restart = c.restart_all()
            for i in range(N_PROC_OSDS):
                boot_check(i)
            clean = c.wait_active_clean(timeout=PROC_CLEAN_TIMEOUT_S)
            report["cold_restart"] = {
                "ready_s": restart["ready_s"], "up_s": restart["up_s"],
                "active_clean_s": time.perf_counter() - t,
                "clean_wait_s": clean, "daemon_ready_s": dict(c.ready_s)}
        step("cold_restart", cold_restart, 0)
        cl = c.client()
        io = cl.open_ioctx(name)
        step("read_after_restart", lambda: read_all("read after restart"),
             all_bytes)

        scrub = {"pgs": 0, "objects": 0, "errors": [], "device_bytes": 0,
                 "host_bytes": 0}

        def deep_scrub():
            for i in range(N_PROC_OSDS):
                res = asok(i, {"prefix": "scrub", "deep": True},
                           timeout=PROC_ASOK_TIMEOUT_S)
                if "error" in res:
                    raise AssertionError(f"osd.{i} scrub: {res}")
                for r in res.values():
                    scrub["pgs"] += 1
                    scrub["objects"] += r["objects"]
                    scrub["errors"] += r["errors"]
                    scrub["device_bytes"] += r.get("device_bytes", 0)
                    scrub["host_bytes"] += r.get("host_bytes", 0)
        step("deep_scrub", deep_scrub, 0)
        st = report["steps"]["deep_scrub"]
        st["bytes"] = scrub["device_bytes"] + scrub["host_bytes"]
        st["GBps"] = st["bytes"] / st["wall_s"] / 1e9
        report["scrub"] = scrub
        if scrub["errors"] or scrub["objects"] != len(expect):
            raise AssertionError(f"deep scrub: {scrub}")
        if on_card and scrub["device_bytes"] <= 0:
            raise AssertionError(f"deep scrub ran no device bytes: {scrub}")
    finally:
        c.stop()
    report["launch_totals"] = daemons.totals
    report["disk_bytes"] = {f"osd.{i}": dir_bytes(root / "data" / f"osd.{i}")
                            for i in range(N_PROC_OSDS)}
    stores = {}
    try:
        for i in range(N_PROC_OSDS):
            stores[i] = create_store("bluestore",
                                     str(root / "data" / f"osd.{i}"))
            stores[i].mount()
        report["shard_crcs"] = store_shard_crcs(stores)
    finally:
        for s in stores.values():
            s.umount()
    if report["shard_crcs"]["hinfo"] < N_PROC_OBJECTS * (K + M) // 2:
        raise AssertionError(f"too few HashInfo crcs checked: "
                             f"{report['shard_crcs']}")
    return report


def phase_proc_cluster(tmp) -> tuple[dict, dict]:
    """Phase M: the process cluster on the card.  The daemons load the
    kernel library the parent built from a cache directory of the run's
    own and inherit the pinned operating point.  Returns (the daemons'
    launch counts, the report)."""
    from ceph_tpu_torch.ops import _build
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    if mode != "Default":
        raise AssertionError(f"phase M needs 13 processes on the card; "
                             f"its compute mode is {mode!r}")
    root = tmp / "proc"
    cache_dir = root / "cache"
    cache_dir.mkdir(parents=True)
    shutil.copy2(_build.library_path(), cache_dir)
    res = proc_cluster_run("cuda", root, cache_dir)
    total = res["launch_totals"]
    missing = [k for k in ("gf_bitmatmul", "fused_hier_acc_call",
                           "crc32c_rows_l") if total.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase M missed kernels {missing}: {total}")
    res["card"] = nvidia_smi_line()
    res["compute_mode"] = mode
    print(f"# proc cluster ({res['card']}): boot {res['boot_s']:.2f} s "
          f"(daemons {res['daemon_ready_s']}); "
          + "; ".join(f"{k} {v['GBps']:.4f} GB/s ({v['wall_s']:.3f} s)"
                      for k, v in res["steps"].items()), flush=True)
    print(f"# proc cluster: SIGKILL to active+clean "
          f"{res['steps']['revive_to_clean']['sigkill_to_clean_s']:.3f} s, "
          f"{res['steps']['revive_to_clean']['bytes']} bytes rebuilt; "
          f"cold restart {res['cold_restart']}; disk bytes "
          f"{res['disk_bytes']}; launches {total}", flush=True)
    return total, res


# Phase N: the block service.  RBD images at Ceph Octopus's
# rbd_default_order = 22 (4 MiB objects, src/common/options.cc) in an EC
# pool `rbd` of ISA-L's canonical k=8 m=3 on the torch plugin (K3
# pinned), 16 PGs, in a process cluster of its own laid out as phase
# M's, driven through the `rbd` and `rados` CLIs.  `rbd bench`'s
# io-total at 4 KiB (its default io-size) is cut from Ceph's 1 GiB to
# 64 KiB: each 4 KiB write on an EC pool is a read-modify-write.  The
# image, the import, the 4 MiB bench and the striped object are cut to
# keep the whole script in its time (PERF.md section 4 lists the cuts).
# The striped object takes libradosstriper's default layout (stripe unit
# 4 MiB, stripe count 1, object size 4 MiB: default_file_layout in
# src/libradosstriper/RadosStriperImpl.cc).
N_RBD_OSDS = 12
RBD_POOL = ("rbd", PROC_POOL[1], 16)
RBD_SIZES = {
    "order": 22,
    "image": 256 << 20,                 # vol0, a thin image
    "import": 64 << 20,                 # vol1, imported from a file
    "bench_big": (4 << 20, 64 << 20),   # rbd bench io-size, io-total
    "bench_small": (4 << 10, 64 << 10),
    "snap_writes": (16, 64 << 10),      # writes after the snapshot
    "child_writes": (16, 4 << 10),      # writes into the clone
    "striper": (16 << 20, 4 << 20, 1, 4 << 20),  # size, su, sc, os
}
RBD_CLI_TIMEOUT_S = 600.0


def check_bytes(got, want: np.ndarray, what: str) -> None:
    """`got` (bytes, or the path of a file) must equal `want`."""
    g = np.fromfile(got, dtype=np.uint8) if isinstance(got, Path) else \
        np.frombuffer(got, dtype=np.uint8)
    if g.size != want.size or not np.array_equal(g, want):
        n = min(g.size, want.size)
        bad = np.flatnonzero(g[:n] != want[:n])
        raise AssertionError(f"{what}: {g.size} bytes (want {want.size}), "
                             f"{bad.size} differ from {bad[:1].tolist()}")


def rbd_sequence(io, cli, rbd_mod, striper_cls, c, revived, root: Path,
                 sizes: dict, step) -> dict:
    """Phase N's traffic on one cluster: images, snapshots, diffs, a
    clone, a striped object, and an export with the OSD of data shard 1
    of the first object down and after its revive.  `cli(tool, argv)`
    runs the `rbd_cli` or `rados_cli` tool on the pool and returns its
    stdout; `rbd_mod` and `striper_cls` are the library's (the parent
    keeps what it expects through them and `io`); `c` is the cluster
    (kill_osd, mark_osd_down, revive_osd, wait_active_clean) and
    `revived(osd)` runs after a revive; `step(label, fn, nbytes)` times
    each step.  Every export and read must equal what was written.
    Returns the CLI's `rbd bench` rates and the sha256 of every export,
    diff stream and striped read."""
    import hashlib
    rng = np.random.default_rng(SEED + 14)
    order, image = str(sizes["order"]), sizes["image"]
    out = {"bench_MBps": {}, "sha256": {}}

    def rbd(*argv):
        return cli("rbd_cli", [str(a) for a in argv])

    def export(name, want, label):
        path = root / f"{label}.img"
        step(label, lambda: rbd("export", name, path), want.size)
        check_bytes(path, want, f"{label}: rbd export {name}")
        out["sha256"][label] = hashlib.sha256(path.read_bytes()).hexdigest()
        path.unlink()

    def bench(label, io_size, io_total):
        def run():
            said = rbd("bench", "vol0", "--io-size", io_size,
                       "--io-total", io_total)
            out["bench_MBps"][label] = float(said.split("=")[-1].split()[0])
        n = min(io_total, image) // io_size
        step(label, run, n * io_size)
        payload = np.random.default_rng(0).integers(0, 256, io_size,
                                                    dtype=np.uint8)
        vol0[:n * io_size] = np.tile(payload, n)

    def seeded_writes(n, length, limit):
        """n (offset, bytes) pairs: 4 KiB aligned, below `limit`."""
        return [(int(rng.integers(0, (limit - length) // 4096 + 1)) * 4096,
                 rng.integers(0, 256, length, dtype=np.uint8))
                for _ in range(n)]

    # 1. a thin image, and an image imported from a file
    vol0 = np.zeros(image, dtype=np.uint8)
    vol1 = rng.integers(0, 256, sizes["import"], dtype=np.uint8)
    vol1.tofile(root / "vol1.src")
    step("create", lambda: rbd("create", "vol0", "--size", image,
                               "--order", order), 0)
    step("import", lambda: rbd("import", root / "vol1.src", "vol1",
                               "--order", order), vol1.size)
    export("vol1", vol1, "export_vol1")
    # 2, 3. rbd bench: whole objects, then 4 KiB read-modify-writes
    bench("bench_big", *sizes["bench_big"])
    bench("bench_small", *sizes["bench_small"])
    # 4. a snapshot, writes under it (copy-on-write clones on the OSDs),
    # the diffs and the exports
    written = sizes["bench_big"][1]
    step("snap_create", lambda: rbd("snap", "create", "vol0@s1"), 0)
    vol0_s1 = vol0.copy()
    patches = seeded_writes(*sizes["snap_writes"], written)
    for off, p in patches:
        vol0[off:off + p.size] = p
    img = rbd_mod.Image(io, "vol0")
    step("snap_writes", lambda: [img.write(off, p.tobytes())
                                 for off, p in patches],
         sum(p.size for _, p in patches))
    img.snap_set("s1")
    got = {}
    step("read_s1", lambda: got.update(s1=img.read(0, image)), image)
    check_bytes(got.pop("s1"), vol0_s1, "vol0@s1 read")
    img.close()
    diff, full = root / "vol0.s1-head.diff", root / "vol0.s1.diff"
    step("export_diff", lambda: rbd("export-diff", "--from-snap", "s1",
                                    "vol0", diff), 0)
    step("export_diff_s1", lambda: rbd("export-diff", "vol0@s1", full), 0)
    for label, path in (("export_diff", diff), ("export_diff_s1", full)):
        out["sha256"][label] = hashlib.sha256(path.read_bytes()).hexdigest()
        out.setdefault("diff_bytes", {})[label] = path.stat().st_size
    export("vol0", vol0, "export_vol0")
    # the reference CLI exports no snapshot: an image rebuilt from the
    # full diff up to s1 (which also makes its s1) stands in for it
    step("import_diff_s1", lambda: (
        rbd("create", "vol0s1", "--size", image, "--order", order),
        rbd("import-diff", full, "vol0s1")), full.stat().st_size)
    export("vol0s1", vol0_s1, "export_vol0s1_at_s1")
    step("import_diff", lambda: rbd("import-diff", diff, "vol0s1"),
         diff.stat().st_size)
    export("vol0s1", vol0, "export_vol0s1")
    # 5. a clone of s1: each first write to a block copies it up
    step("clone", lambda: rbd("clone", "vol0@s1", "child"), 0)
    child_want = vol0_s1.copy()
    patches = seeded_writes(*sizes["child_writes"], written)
    for off, p in patches:
        child_want[off:off + p.size] = p
    child = rbd_mod.Image(io, "child")
    step("child_writes", lambda: [child.write(off, p.tobytes())
                                  for off, p in patches],
         sum(p.size for _, p in patches))
    child.close()
    export("child", child_want, "export_child")
    # 6. a striped object, read whole, in part, and its first piece
    # through `rados get`
    size, su, sc, os_ = sizes["striper"]
    so = striper_cls(io, "striped", stripe_unit=su, stripe_count=sc,
                     object_size=os_)
    blob = rng.integers(0, 256, size, dtype=np.uint8)
    step("striper_write", lambda: so.write(blob.tobytes()), size)
    lo, hi = 3 * su + 12345, 4 * su + 13122

    step("striper_read", lambda: got.update(whole=so.read(),
                                            part=so.read(hi - lo, offset=lo)),
         size + hi - lo)
    check_bytes(got["whole"], blob, "striped read")
    check_bytes(got.pop("part"), blob[lo:hi], "striped unaligned read")
    out["sha256"]["striper"] = hashlib.sha256(got.pop("whole")).hexdigest()
    step("rados_get", lambda: cli("rados_cli", [
        "get", "striped.0000000000000000", str(root / "piece0")]), os_)
    check_bytes(root / "piece0", blob[:os_], "rados get of piece 0")
    # 7. the OSD of data shard 1 of vol0's first object down, then back
    victim = out["victim"] = kill_shard_holder(
        c, io, "rbd_data.vol0.0000000000000000")
    export("vol0", vol0, "export_degraded")

    def revive():
        c.revive_osd(victim)
        revived(victim)
        c.wait_active_clean(timeout=PROC_CLEAN_TIMEOUT_S)
    step("revive_to_clean", revive, 0)
    export("vol0", vol0, "export_after_revive")
    return out


def block_service_run(device: str, root, cache_dir) -> dict:
    """Phase N on one process cluster over BlueStore: rbd_sequence
    through the `rbd` and `rados` CLIs, each a subprocess with `-m` the
    mon's address.  Each step's launches are read through the daemons'
    `launch profile`, as phase M's are."""
    from ceph_tpu_torch import rbd as rbd_mod
    from ceph_tpu_torch.rados.striper import StripedObject
    from ceph_tpu_torch.tools.proc_cluster import ProcCluster
    asok_dir = root / "asok"
    asok_dir.mkdir(parents=True)
    report = {"osds": N_RBD_OSDS, "steps": {}, "launches": {}}
    c = ProcCluster(n_osds=N_RBD_OSDS, objectstore="bluestore",
                    data_dir=str(root / "data"), asok_dir=str(asok_dir),
                    heartbeat_interval=0.0, prewarm=True,
                    compile_cache_dir=str(cache_dir),
                    boot_timeout=PROC_BOOT_TIMEOUT_S, device=device)
    daemons = ProcDaemons(c, cache_dir)

    def step(label, fn, nbytes):
        report["steps"][label] = timed(fn, nbytes)
        report["launches"][label] = daemons.read_launches()

    name, profile, pg_num = RBD_POOL
    here = os.path.dirname(os.path.abspath(__file__))

    def cli(tool, argv):
        mon = "%s:%d" % tuple(c.mon_addrs[0])
        proc = subprocess.run(
            [sys.executable, "-m", f"ceph_tpu_torch.tools.{tool}", "-m",
             mon, "-p", name, *argv], capture_output=True, text=True,
            cwd=here, timeout=RBD_CLI_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"{tool} {argv} exited {proc.returncode}:"
                                 f"\n{proc.stderr[-4000:]}")
        return proc.stdout

    t0 = time.perf_counter()
    try:
        c.start()
        report["boot_s"] = time.perf_counter() - t0
        for i in range(N_RBD_OSDS):
            daemons.boot_check(i)
        cl = c.client()
        cl.set_ec_profile(name, profile)
        cl.create_pool(name, "erasure", erasure_code_profile=name,
                       pg_num=pg_num)
        io = cl.open_ioctx(name)
        report.update(rbd_sequence(io, cli, rbd_mod, StripedObject, c,
                                   daemons.boot_check, root, RBD_SIZES,
                                   step))
    finally:
        c.stop()
    report["launch_totals"] = daemons.totals
    return report


def phase_block_service(tmp) -> tuple[dict, dict]:
    """Phase N: the block service on the card, in a process cluster of
    its own whose daemons load the library the parent built.  Returns
    (the daemons' launch counts, the report)."""
    from ceph_tpu_torch.ops import _build
    root = tmp / "rbd"
    cache_dir = root / "cache"
    cache_dir.mkdir(parents=True)
    shutil.copy2(_build.library_path(), cache_dir)
    res = block_service_run("cuda", root, cache_dir)
    total = res["launch_totals"]
    missing = [k for k in ("gf_bitmatmul", "fused_hier_acc_call")
               if total.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase N missed kernels {missing}: {total}")
    res["card"] = nvidia_smi_line()
    print(f"# block service ({res['card']}): boot {res['boot_s']:.2f} s; "
          + "; ".join(f"{k} {v['GBps']:.4f} GB/s ({v['wall_s']:.3f} s)"
                      for k, v in res["steps"].items())
          + f"; rbd bench {res['bench_MBps']} MB/s; launches {total}",
          flush=True)
    return total, res


# Phase O: the file service and the cluster tools.  CephFS on an
# erasure-coded data pool (Ceph's doc/cephfs/createfs.rst, "Using Erasure
# Coded pools with CephFS") at the default file layout
# (doc/cephfs/file-layouts.rst: stripe unit 4 MiB, stripe count 1, object
# size 4 MiB, which is the MDS's default block_size): `cephfs_data` of
# torch k=8 m=3 (K3 pinned), 16 PGs, made before the MDS boots, which
# keeps it; `cephfs_metadata` replicated, made by the MDS.  A process
# cluster of its own laid out as phase M's, one MDS process, a mgr in
# the parent with the default modules and the dashboard (Octopus runs
# the balancer in upmap mode by default).  File counts and cluster_bench's
# seconds are cut to keep the whole script in its time (PERF.md section
# 4).
N_FS_OSDS = 12
FS_POOL = ("cephfs_data", PROC_POOL[1], 16)
FS_SIZES = {
    "dirs": 4,                     # /vol/d0 ... /vol/d3
    "big": (4, 16 << 20),          # files, bytes each: 4 blocks of 4 MiB
    "small": (16, 64 << 10),
    "overwrites": (16, 64 << 10),  # each round, at 4 KiB aligned offsets
    "unlinks": 8,
}
FS_BALANCE_WAIT_S = 60.0
FS_HEALTH_WAIT_S = 30.0
FS_PROGRESS_WAIT_S = 60.0
FS_TOOL_TIMEOUT_S = 600.0
# cluster_bench's thread topology (its default: 12 OSDs on MemStore) on
# the card, the quick matrix and the mesh row over every visible card
FS_BENCH_ARGV = ["--quick", "--mesh", "--size", str(4 << 20),
                 "--seconds", "1"]


def fs_namespace(fs, path="/") -> dict:
    """{path: (size, mode)} of every entry under `path`, walked through
    readdir (times left out)."""
    out = {}
    for name, ent in fs.readdir(path):
        p = f"{path.rstrip('/')}/{name}"
        out[p] = (ent.get("size", 0), ent["mode"])
        if ent["mode"] & 0o040000:
            out.update(fs_namespace(fs, p))
    return out


def fs_sequence(fs, mount, c, revived, restart_mds, sizes: dict, step,
                check=check_bytes, degraded=None, recovered=None) -> dict:
    """Phase O's file traffic on one cluster: directories, whole-block
    file writes and small files, 4 KiB aligned overwrites (read-modify-
    writes), a truncate to an unaligned size, a directory rename,
    unlinks whose data objects must be purged, a snapshot with more
    overwrites under it, a second client reading everything, the OSD of
    data shard 1 of the first file's first block down for degraded
    reads and back to active+clean, and an MDS restart after which a
    fresh client must see the same namespace, files and snapshot.

    `fs` is a mounted CephFS client and `mount(addr=None)` mounts
    another (on the MDS at `addr` when given); `c` is the cluster
    (kill_osd, mark_osd_down, revive_osd, wait_active_clean);
    `revived(osd)` runs after the revive; `restart_mds()` kills the MDS,
    starts it again under its name and returns its address; `degraded()`
    runs while the OSD is down and `recovered()` after active+clean;
    `step(label, fn, nbytes, ops)` times each step; `check(got, want,
    what)` holds a read to the bytes written.  Returns the namespace,
    the sha256 of every file and snapshot view as the fresh client read
    it, the overwrites ((path, offset, length), paths as they end) and
    the victim."""
    import hashlib
    data_oid = sys.modules[type(fs).__module__].data_oid
    rng = np.random.default_rng(SEED + 15)
    n_dirs = sizes["dirs"]
    n_big, big = sizes["big"]
    n_small, small = sizes["small"]
    n_ow, ow_len = sizes["overwrites"]
    dirs = [f"/vol/d{i}" for i in range(n_dirs)]
    want = {}                      # path -> the bytes expected
    bigs = [f"{dirs[i % n_dirs]}/big{i}" for i in range(n_big)]
    smalls = [f"{dirs[i % n_dirs]}/small{i}" for i in range(n_small)]
    out = {"overwrites": [], "sha256": {}}

    def read_all(client, expect, what, digest=None):
        for p in sorted(expect):
            got = client.read_file(p)
            check(got, expect[p], f"{what}: {p}")
            if digest is not None:
                digest[p] = hashlib.sha256(got).hexdigest()

    def overwrite(label):
        patches = []
        for _ in range(n_ow):
            p = bigs[int(rng.integers(0, n_big))]
            size = want[p].size
            off = int(rng.integers(0, (size - ow_len) // 4096 + 1)) * 4096
            patch = rng.integers(0, 256, ow_len, dtype=np.uint8)
            want[p][off:off + ow_len] = patch
            patches.append((p, off, patch))

        def run():
            for p, off, patch in patches:
                with fs.open(p, "r+") as f:
                    f.pwrite(patch.tobytes(), off)
        step(label, run, n_ow * ow_len, n_ow)
        out["overwrites"] += [(p, off, ow_len) for p, off, _ in patches]

    def rename_dir(old, new):
        fs.rename(old, new)
        for paths in (bigs, smalls):
            paths[:] = [new + p[len(old):] if p.startswith(old + "/")
                        else p for p in paths]
        for p in [p for p in want if p.startswith(old + "/")]:
            want[new + p[len(old):]] = want.pop(p)
        out["overwrites"] = [(new + p[len(old):] if p.startswith(old + "/")
                              else p, o, n) for p, o, n in out["overwrites"]]

    # 2. directories, whole-block files (K3), small files
    step("makedirs", lambda: [fs.makedirs(d) for d in dirs], 0, n_dirs)
    for p in bigs:
        want[p] = rng.integers(0, 256, big, dtype=np.uint8)
    step("write_big", lambda: [fs.write_file(p, want[p].tobytes())
                               for p in bigs], n_big * big, n_big)
    for p in smalls:
        want[p] = rng.integers(0, 256, small, dtype=np.uint8)
    step("write_small", lambda: [fs.write_file(p, want[p].tobytes())
                                 for p in smalls], n_small * small, n_small)
    # 3. overwrites (read-modify-writes: K1 encodes), a truncate, a
    # rename, unlinks whose data objects are purged
    overwrite("overwrite")
    cut = bigs[1]
    size = want[cut].size * 3 // 4 - 777

    def truncate():
        with fs.open(cut, "r+") as f:
            f.truncate(size)
    step("truncate", truncate, 0, 1)
    want[cut] = want[cut][:size]
    step("rename", lambda: rename_dir(dirs[-1], dirs[-1] + "r"), 0, 1)
    dirs[-1] += "r"
    gone = [smalls[int(i)] for i in sorted(rng.choice(
        n_small, sizes["unlinks"], replace=False))]
    inos = [fs.stat(p)["ino"] for p in gone]
    step("unlink", lambda: [fs.unlink(p) for p in gone], 0, len(gone))
    for p, ino in zip(gone, inos):
        want.pop(p)
        smalls.remove(p)
        try:
            fs.data.read(data_oid(ino, 0), 1)
        except Exception as e:  # noqa: BLE001 - the package's RadosError
            if getattr(e, "errno", None) != 2:
                raise
        else:
            raise AssertionError(f"unlink left {p}'s data object")
    # 4. a snapshot, then overwrites under it (copy-on-write clones)
    step("snap_create", lambda: fs.snap_create("/vol", "s1"), 0, 1)
    snap = {"/vol/.snap/s1" + p[len("/vol"):]: v.copy()
            for p, v in want.items()}
    overwrite("overwrite_snap")
    step("read_snap", lambda: read_all(fs, snap, "snapshot view"),
         sum(v.size for v in snap.values()), len(snap))
    # 5. a second client: every directory and every file
    fs2 = mount()
    names = {}
    step("readdir", lambda: names.update(
        (d, sorted(n for n, _ in fs2.readdir(d))) for d in ["/vol", *dirs]),
        0, n_dirs + 1)
    if names["/vol"] != sorted(d.rsplit("/", 1)[1] for d in dirs):
        raise AssertionError(f"/vol lists {names['/vol']}")
    for d in dirs:
        listed = [f"{d}/{n}" for n in names[d]]
        if listed != sorted(p for p in want if p.startswith(d + "/")):
            raise AssertionError(f"{d} lists {names[d]}")
    step("read_second_client", lambda: read_all(fs2, want, "second client"),
         sum(v.size for v in want.values()), len(want))
    ns = fs_namespace(fs2)
    # 6. the OSD of data shard 1 of the first file's first block down
    victim = out["victim"] = kill_shard_holder(
        c, fs.data, data_oid(fs.stat(bigs[0])["ino"], 0))
    if degraded is not None:
        degraded()
    big_want = {p: want[p] for p in bigs}
    big_bytes = sum(v.size for v in big_want.values())
    step("read_degraded", lambda: read_all(fs, big_want, "degraded read"),
         big_bytes, n_big)

    def revive():
        c.revive_osd(victim)
        revived(victim)
        c.wait_active_clean(timeout=PROC_CLEAN_TIMEOUT_S)
    step("revive_to_clean", revive, 0)
    if recovered is not None:
        recovered()
    step("read_after_revive", lambda: read_all(fs, big_want,
                                               "read after revive"),
         big_bytes, n_big)
    # 7. the MDS killed and started again: a fresh client sees it all
    addr = {}
    step("mds_restart", lambda: addr.update(mds=restart_mds()), 0, 1)
    fs3 = mount(addr["mds"])
    if fs_namespace(fs3) != ns:
        raise AssertionError("the namespace changed across the MDS restart")
    if fs3.snap_list("/vol") != ["s1"]:
        raise AssertionError(f"snapshots {fs3.snap_list('/vol')}")
    want.update(snap)
    step("read_after_mds_restart", lambda: read_all(
        fs3, want, "after the MDS restart", out["sha256"]),
        sum(v.size for v in want.values()), len(want))
    out["namespace"] = ns
    return out


def file_service_run(device: str, root, cache_dir) -> dict:
    """Phase O on one process cluster over BlueStore: the mgr first (the
    balancer's moves settle), one MDS process, fs_sequence through a
    CephFS client in the parent with `ceph_cli health` and the mgr's
    health while the OSD is down and `ceph_cli progress` after its
    recovery, the tools against the cluster (`ceph_cli` and its daemon
    mode, the metrics exporter, the dashboard), then cluster_bench in a
    subprocess.  Each step's launches are read through the daemons'
    `launch profile`, as phase M's are."""
    import urllib.request

    from ceph_tpu_torch.fs import CephFS
    from ceph_tpu_torch.mgr import MgrDaemon
    from ceph_tpu_torch.mgr.modules import (DEFAULT_MODULES,
                                            BalancerModule, DashboardModule)
    from ceph_tpu_torch.tools import metrics_exporter
    from ceph_tpu_torch.tools.proc_cluster import ProcCluster
    asok_dir = root / "asok"
    asok_dir.mkdir(parents=True)
    report = {"osds": N_FS_OSDS, "steps": {}, "launches": {}, "tools": {}}
    c = ProcCluster(n_osds=N_FS_OSDS, objectstore="bluestore",
                    data_dir=str(root / "data"), asok_dir=str(asok_dir),
                    heartbeat_interval=0.0, prewarm=True,
                    compile_cache_dir=str(cache_dir),
                    boot_timeout=PROC_BOOT_TIMEOUT_S, device=device)
    daemons = ProcDaemons(c, cache_dir)
    here = os.path.dirname(os.path.abspath(__file__))

    def step(label, fn, nbytes, ops=0):
        st = report["steps"][label] = timed(fn, nbytes)
        if ops:
            st.update(ops=ops, ops_s=ops / st["wall_s"])
        report["launches"][label] = daemons.read_launches()

    def tool(name, *argv):
        proc = subprocess.run(
            [sys.executable, "-m", f"ceph_tpu_torch.tools.{name}",
             *map(str, argv)], capture_output=True, text=True, cwd=here,
            timeout=FS_TOOL_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"{name} {argv} exited {proc.returncode}:"
                                 f"\n{proc.stderr[-4000:]}")
        return proc.stdout

    def ceph(*words):
        return json.loads(tool("ceph_cli", "-m", mon, *words))

    def poll(what, fn, timeout):
        t = time.perf_counter()
        deadline = time.time() + timeout
        while not fn():
            if time.time() > deadline:
                raise AssertionError(f"{what}: not within {timeout} s")
            time.sleep(0.5)
        report["tools"][what + "_s"] = time.perf_counter() - t

    clients, mgr = [], None
    mds_addr = {}

    def mount(addr=None):
        fs = CephFS(c.mon_addrs, addr or mds_addr["a"],
                    name=f"fsclient{len(clients)}")
        clients.append(fs)
        return fs

    def restart_mds():
        c.kill_mds("a")
        mds_addr["a"] = c.spawn_mds("a")
        return mds_addr["a"]

    def degraded():
        def warned():
            h = ceph("health")
            return h.get("status") == "HEALTH_WARN" and \
                "PG_DEGRADED" in h.get("checks", {})
        poll("ceph_health_warn", warned, FS_HEALTH_WAIT_S)
        poll("mgr_health_warn", lambda: mgr.health_summary()["status"] ==
             "HEALTH_WARN" and "health" in mgr.health_summary()["checks"],
             FS_HEALTH_WAIT_S)

    def recovered():
        def done():
            evs = {e["id"]: e for e in ceph("progress")["events"]}
            return evs.get("recovery", {}).get("progress") == 1.0
        poll("progress_recovery_done", done, FS_PROGRESS_WAIT_S)

    name, profile, pg_num = FS_POOL
    t0 = time.perf_counter()
    try:
        c.start()
        report["boot_s"] = time.perf_counter() - t0
        for i in range(N_FS_OSDS):
            daemons.boot_check(i)
        mon = "%s:%d" % tuple(c.mon_addrs[0])
        cl = c.client()
        cl.set_ec_profile(name, profile)
        cl.create_pool(name, "erasure", erasure_code_profile=name,
                       pg_num=pg_num)
        t = time.perf_counter()
        mds_addr["a"] = c.spawn_mds("a")
        report["mds_boot_s"] = time.perf_counter() - t
        # 1. the mgr before any file data; the balancer's moves settle
        mgr = MgrDaemon(c.mon_addrs,
                        modules=[*DEFAULT_MODULES, DashboardModule]).start()
        bal = next(m for m in mgr.modules if isinstance(m, BalancerModule))
        t = time.perf_counter()
        deadline = time.time() + FS_BALANCE_WAIT_S
        while bal.compute_moves() and time.time() < deadline:
            time.sleep(0.5)
        report["balancer"] = {"moves": bal.moves,
                              "pending": len(bal.compute_moves()),
                              "wait_s": time.perf_counter() - t}
        c.wait_active_clean(timeout=PROC_CLEAN_TIMEOUT_S)
        daemons.read_launches()
        # 2-7. the file traffic
        report.update(fs_sequence(
            mount(), mount, c, daemons.boot_check, restart_mds, FS_SIZES,
            step, degraded=degraded, recovered=recovered))
        report["health"] = mgr.health_summary()
        # 8. the tools against this cluster
        for words in (["status"], ["osd", "tree"], ["pg", "stat"]):
            report["tools"][" ".join(words)] = ceph(*words)
        said = json.loads(tool("ceph_cli", "daemon",
                               c.asok_path("osd.0"), "launch", "profile"))
        now = daemons.asok(0, {"prefix": "launch profile"})
        if said["kernel_launches"] != now["kernel_launches"]:
            raise AssertionError(f"ceph daemon launch profile "
                                 f"{said['kernel_launches']} != "
                                 f"{now['kernel_launches']}")
        report["tools"]["osd.0 kernel_launches"] = said["kernel_launches"]
        text = metrics_exporter.collect(str(asok_dir))
        for d in ["mon.0", *(f"osd.{i}" for i in range(N_FS_OSDS))]:
            if f'ceph_tpu_daemon_up{{daemon="{d}"}} 1' not in text:
                raise AssertionError(f"the exporter has {d} not up")
        gauges = [ln for ln in text.splitlines()
                  if ln.startswith("ceph_tpu_lat_launch_device_p99{")]
        if not gauges:
            raise AssertionError("the exporter has no launch-latency gauge")
        report["tools"]["exporter"] = {"lines": len(text.splitlines()),
                                       "launch_p99_gauges": len(gauges)}
        dash = next(m for m in mgr.modules
                    if isinstance(m, DashboardModule))
        with urllib.request.urlopen(
                f"http://{dash.addr[0]}:{dash.addr[1]}/api/health",
                timeout=30) as r:
            api = json.loads(r.read())["status"]
        if api != mgr.health_summary()["status"]:
            raise AssertionError(f"dashboard {api} != mgr "
                                 f"{mgr.health_summary()}")
        report["tools"]["dashboard_health"] = api
    finally:
        if mgr is not None:
            mgr.shutdown()
        for fs in clients:
            fs.shutdown()
        c.stop()
    report["launch_totals"] = daemons.totals
    # 9. cluster_bench on the card: the thread topology's quick matrix
    t = time.perf_counter()
    said = tool("cluster_bench", *FS_BENCH_ARGV, "--device", device)
    report["cluster_bench_s"] = time.perf_counter() - t
    rows = [json.loads(ln) for ln in said.splitlines()
            if ln.startswith("{")]
    bench = [r for r in rows if "write_mb_s" in r]
    report["cluster_bench"] = rows
    for r in bench:
        if not (r["write_mb_s"] > 0 and (r["read_mb_s"] or 0) > 0):
            raise AssertionError(f"cluster_bench row {r['config']}: "
                                 f"{r['write_mb_s']} / {r['read_mb_s']}")
    mesh = next((r for r in bench if r["config"] == "ec_k8m3_mesh"), None)
    if mesh is None or mesh["mesh"] is None:
        raise AssertionError(f"cluster_bench published no mesh row: "
                             f"{[r['config'] for r in bench]}")
    return report


def phase_file_service(tmp) -> tuple[dict, dict]:
    """Phase O: the file service and the cluster tools on the card, in a
    process cluster of its own whose daemons load the library the parent
    built.  Returns (the daemons' launch counts, the report)."""
    from ceph_tpu_torch.ops import _build
    root = tmp / "fs"
    cache_dir = root / "cache"
    cache_dir.mkdir(parents=True)
    shutil.copy2(_build.library_path(), cache_dir)
    res = file_service_run("cuda", root, cache_dir)
    total = res["launch_totals"]
    missing = [k for k in ("gf_bitmatmul", "fused_hier_acc_call")
               if total.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase O missed kernels {missing}: {total}")
    bench = [r for r in res["cluster_bench"] if "write_mb_s" in r]
    mesh = next(r for r in bench if r["config"] == "ec_k8m3_mesh")
    if mesh["launch_ledger"]["kernel_launches"].get("gf_bitmatmul", 0) <= 0:
        raise AssertionError(f"cluster_bench's mesh row launched no K1: "
                             f"{mesh['launch_ledger']}")
    res["card"] = nvidia_smi_line()
    print(f"# file service ({res['card']}): boot {res['boot_s']:.2f} s, "
          f"mds {res['mds_boot_s']:.2f} s; balancer {res['balancer']}; "
          + "; ".join(f"{k} {v['GBps']:.4f} GB/s"
                      + (f" {v['ops_s']:.1f} op/s" if v.get("ops") else "")
                      + f" ({v['wall_s']:.3f} s)"
                      for k, v in res["steps"].items())
          + f"; tools {res['tools']}; launches {total}", flush=True)
    for r in bench:
        print(f"# cluster_bench {r['config']}: write {r['write_mb_s']} MB/s, "
              f"read {r['read_mb_s']} MB/s, mesh {r['mesh']}, kernel "
              f"launches {r['launch_ledger']['kernel_launches']}",
              flush=True)
    return total, res


# Phase P: the object service.  RGW with an erasure-coded data pool and
# a replicated index pool (Ceph's doc/radosgw/pools.rst and
# doc/rados/operations/erasure-code.rst) at Octopus's RGW defaults in
# src/common/options.cc: objects up to rgw_max_chunk_size /
# rgw_obj_stripe_size (4 MiB) in one RADOS object, multipart parts of
# rgw_multipart_min_part_size (5 MiB).  `.rgw.data` of torch k=8 m=3 (K3
# pinned), 16 PGs, made before any gateway starts, which keeps it;
# `.rgw.meta` replicated, made by the gateway.  A process cluster of its
# own laid out as phase M's, the gateway a process of its own (the
# `radosgw` entry point with SigV4 on), and a second zone, an in-process
# cluster on the card, that syncs from it.  The object counts are cut to
# keep the whole script in its time (PERF.md section 4): the full sync
# and the zone compare read every object.
N_RGW_OSDS = 12
RGW_POOL = ("rgw_k8m3", PROC_POOL[1], 16)
RGW_ZONE_B_OSDS = 12
RGW_ACCESS, RGW_SECRET = "chipsmoke", "chipsmoke-secret"
RGW_SIZES = {
    "buckets": 4,                  # b0 ... b3
    "big": (16, 4 << 20),          # objects, bytes each: one RADOS object
    "threads": 8,                  # client threads of the big PUTs, GETs
    "small": (16, 64 << 10),
    "multipart": (2, 4, 5 << 20),  # uploads, parts each, bytes a part
    "version": 4 << 20,            # a key PUT twice on a versioned bucket
    "lifecycle": (8, 64 << 10),    # objects under tmp/, expired
    "page": 7,                     # max-keys of each listing page
    "reshard": 8,                  # b3's index shards after the reshard
    "swift": 4 << 20,
    "notify": (8, 4 << 20),        # objects PUT into n0, one event each
}
RGW_BOOT_TIMEOUT_S = 120.0
RGW_EVENT_WAIT_S = 60.0
DAY_S = 86400


class S3Client:
    """A raw-HTTP S3 client that signs every request with SigV4 through
    the package's `sigv4` module (tests/test_rgw.py's client).  A 5xx
    answer raises; any other status comes back with its headers and
    body."""

    def __init__(self, addr, sigv4, access=RGW_ACCESS, secret=RGW_SECRET):
        self.host = f"{addr[0]}:{addr[1]}"
        self.sigv4, self.access, self.secret = sigv4, access, secret

    def request(self, method, path, query="", body=b"", headers=None,
                sign=True):
        import urllib.error
        import urllib.request
        headers = {"host": self.host, **(headers or {})}
        if sign:
            headers.update(self.sigv4.sign_request(
                method, path, query, headers, body, self.access,
                self.secret))
        url = f"http://{self.host}{path}" + (f"?{query}" if query else "")
        req = urllib.request.Request(url, data=body if body else None,
                                     method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            if e.code >= 500:
                raise AssertionError(f"{method} {path}?{query}: the "
                                     f"gateway answered {e.code}: "
                                     f"{e.read()[:500]!r}") from e
            return e.code, dict(e.headers), e.read()


class EventReceiver:
    """A local HTTP endpoint that records the S3 event records pushed to
    it (a notification topic's endpoint)."""

    def __init__(self):
        import http.server
        outer = self
        self.records: list[dict] = []

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003
                pass

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                outer.records += json.loads(self.rfile.read(n))["Records"]
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     _Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/events"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def zone_state(store) -> dict:
    """{bucket: {acl, owner, objects: {key: sha256 of its bytes}}} of
    every bucket's current objects (tests/test_rgw_multisite.py's
    _zone_state, with digests for bytes)."""
    import hashlib
    out = {}
    for bucket, meta in store.list_buckets():
        entries, _cps, _trunc, _marker = store.list_objects(
            bucket, "", "", 100000, "", "")
        out[bucket] = {"acl": meta.get("acl", "private"),
                       "owner": meta.get("owner"),
                       "objects": {k: hashlib.sha256(bytes(
                           store.get_object(bucket, k)[0])).hexdigest()
                           for k, _m in entries}}
    return out


def s3_listing(s3, bucket: str, delimiter: str, page: int) -> list:
    """Every page of a ListObjectsV2 of `bucket` at `page` keys a page:
    [(keys as (key, size, etag), common prefixes)]."""
    import re
    import urllib.parse
    pages, token = [], ""
    while True:
        q = {"list-type": "2", "max-keys": str(page)}
        if delimiter:
            q["delimiter"] = delimiter
        if token:
            q["continuation-token"] = token
        st, _, body = s3.request("GET", f"/{bucket}",
                                 urllib.parse.urlencode(q))
        if st != 200:
            raise AssertionError(f"list {bucket}: {st} {body[:300]!r}")
        text = body.decode()
        keys = [(k, int(s), e) for k, s, e in re.findall(
            r"<Contents><Key>([^<]*)</Key><Size>(\d+)</Size>"
            r"<ETag>&quot;([^&]*)&quot;</ETag></Contents>", text)]
        cps = re.findall(r"<CommonPrefixes><Prefix>([^<]*)</Prefix>", text)
        pages.append((keys, cps))
        m = re.search(r"<NextContinuationToken>([^<]*)<", text)
        if "<IsTruncated>true" not in text or not m:
            return pages
        token = m.group(1)


def store_listing(store, bucket: str, delimiter: str, page: int) -> list:
    """s3_listing's pages, read through an RGWStore."""
    pages, resume = [], ""
    while True:
        entries, cps, truncated, resume = store.list_objects(
            bucket, "", "", page, delimiter, resume)
        pages.append(([(k, m["size"], m["etag"]) for k, m in entries],
                      list(cps)))
        if not truncated or not resume:
            return pages


def expected_listing(etags: dict, bucket: str, delimiter: str) -> tuple:
    """The keys and common prefixes a listing of `bucket` must show, from
    {(bucket, key): (size, etag)} of its current objects."""
    keys, cps = [], set()
    for (b, k), (size, etag) in sorted(etags.items()):
        if b != bucket:
            continue
        if delimiter and delimiter in k:
            cps.add(k.split(delimiter, 1)[0] + delimiter)
        else:
            keys.append((k, size, etag))
    return keys, sorted(cps)


def object_sequence(addr, rgw, client, c, revived, restart_gateway,
                    zone_b, sizes: dict, step, check=check_bytes) -> dict:
    """Phase P's object traffic on one cluster: S3 through the gateway at
    `addr` (SigV4 with RGW_ACCESS / RGW_SECRET): buckets b0-b3, 4 MiB
    PUTs from client threads (ETag = md5), 64 KiB PUTs, two multipart
    uploads and a server-side copy; versioning (two versions of a key, a
    delete marker) and a lifecycle rule expiring tmp/ run through a store
    in the parent with a clock two days on; every bucket listed with a
    delimiter and in pages, b3 resharded through a store in the parent
    and listed again through the gateway and the store; Swift on the
    same objects; the OSD of data shard 1 of the first big object down
    for degraded GETs and back to active+clean; the gateway killed and
    started again; then a store in the parent with a mod-log:
    notifications to a local receiver from a new bucket n0, a full sync
    to the second zone, PUTs into n0 and an incremental sync, after
    which the zones must hold the same objects.

    `rgw` holds the package's `sigv4`, `store` and `sync` modules;
    `client` is a RADOS client of the cluster `c` (kill_osd,
    mark_osd_down, revive_osd, wait_active_clean), `revived(osd)` runs
    after the revive, `restart_gateway()` kills the gateway, starts it
    again and returns its address; `zone_b` is a RADOS client of the
    second zone, whose `.rgw.data` the caller made; `step(label, fn,
    nbytes, ops)` times each step; `check(got, want, what)` holds a read
    to the bytes expected.  Returns what two packages must agree on:
    every response (status, ETag), the listings, the versions, the
    multipart manifests, the events, the zone's state, the data objects
    and the victim."""
    import concurrent.futures
    import hashlib
    import re
    sigv4, st_mod, sync_mod = rgw.sigv4, rgw.store, rgw.sync
    rng = np.random.default_rng(SEED + 16)
    buckets = [f"b{i}" for i in range(sizes["buckets"])]
    n_big, big = sizes["big"]
    n_small, small = sizes["small"]
    n_mp, n_parts, part = sizes["multipart"]
    n_lc, lc_size = sizes["lifecycle"]
    n_ev, ev_size = sizes["notify"]
    page = sizes["page"]
    pool = concurrent.futures.ThreadPoolExecutor(sizes["threads"])
    s3 = [S3Client(addr, sigv4)]
    want = {}                      # (bucket, key) -> bytes expected
    etags = {}                     # (bucket, key) -> (size, ETag)
    out = {"responses": [], "data_oids": []}
    store = st_mod.RGWStore(client)

    def req(method, path, query="", body=b"", headers=None, ok=200):
        st, hd, bd = s3[0].request(method, path, query, body, headers)
        # upload and version ids are random: recorded without them
        out["responses"].append((method, path, re.sub(
            r"(uploadId|versionId)=[^&]*", r"\1=*", query), st,
            hd.get("ETag")))
        if st != ok:
            raise AssertionError(f"{method} {path}?{query}: {st}, want "
                                 f"{ok}: {bd[:300]!r}")
        return hd, bd

    def put(bucket, key, data):
        hd, _ = req("PUT", f"/{bucket}/{key}", body=data.tobytes())
        etag = hd["ETag"].strip('"')
        if etag != hashlib.md5(data.tobytes()).hexdigest():
            raise AssertionError(f"PUT {bucket}/{key}: ETag {etag}")
        want[(bucket, key)] = data
        etags[(bucket, key)] = (data.size, etag)

    def get(bucket, key, what, **kw):
        _, body = req("GET", f"/{bucket}/{key}", **kw)
        check(body, want[(bucket, key)], f"{what}: {bucket}/{key}")

    def get_all(keys, what):
        for f in [pool.submit(get, b, k, what) for b, k in keys]:
            f.result()

    def nbytes(keys):
        return sum(want[k].size for k in keys)

    def gone(oid):
        try:
            store.data.read(oid, 1)
        except Exception as e:  # noqa: BLE001 - the package's RadosError
            if getattr(e, "errno", None) != 2:
                raise
            return True
        return False

    try:
        # 1. buckets, then 4 MiB objects from client threads (K3)
        step("create_buckets", lambda: [req("PUT", f"/{b}")
                                        for b in buckets], 0, len(buckets))
        bigs = [(buckets[i % len(buckets)], f"obj{i:03d}")
                for i in range(n_big)]
        body = {k: rng.integers(0, 256, big, dtype=np.uint8) for k in bigs}
        step("put_big", lambda: [f.result() for f in [
            pool.submit(put, b, k, body[(b, k)]) for b, k in bigs]],
            n_big * big, n_big)
        # 2. 64 KiB objects, one at a time (K2 flat)
        smalls = [(buckets[i % len(buckets)], f"small/s{i:03d}")
                  for i in range(n_small)]
        body = {k: rng.integers(0, 256, small, dtype=np.uint8)
                for k in smalls}
        step("put_small", lambda: [put(b, k, body[(b, k)])
                                   for b, k in smalls],
             n_small * small, n_small)
        # 3. multipart uploads, then a server-side copy
        mps = [("b0", f"mp/u{u}") for u in range(n_mp)]
        parts = {k: [rng.integers(0, 256, part, dtype=np.uint8)
                     for _ in range(n_parts)] for k in mps}

        def multipart(bucket, key):
            _, bd = req("POST", f"/{bucket}/{key}", "uploads")
            uid = re.search(rb"<UploadId>([^<]+)</UploadId>",
                            bd).group(1).decode()
            rows = []
            for n, p in enumerate(parts[(bucket, key)], 1):
                hd, _ = req("PUT", f"/{bucket}/{key}",
                            f"partNumber={n}&uploadId={uid}", p.tobytes())
                rows.append(f"<Part><PartNumber>{n}</PartNumber><ETag>"
                            f"{hd['ETag']}</ETag></Part>")
            _, bd = req("POST", f"/{bucket}/{key}", f"uploadId={uid}",
                        ("<CompleteMultipartUpload>" + "".join(rows) +
                         "</CompleteMultipartUpload>").encode())
            etag = re.search(rb"<ETag>&quot;([^&]+)&quot;</ETag>",
                             bd).group(1).decode()
            form = hashlib.md5(b"".join(
                hashlib.md5(p.tobytes()).digest()
                for p in parts[(bucket, key)])).hexdigest() + \
                f"-{n_parts}"
            if etag != form:
                raise AssertionError(f"{bucket}/{key}: multipart ETag "
                                     f"{etag}, want {form}")
            want[(bucket, key)] = np.concatenate(parts[(bucket, key)])
            etags[(bucket, key)] = (want[(bucket, key)].size, etag)
        step("multipart", lambda: [multipart(b, k) for b, k in mps],
             n_mp * n_parts * part, n_mp * (n_parts + 2))
        step("get_multipart", lambda: [get(b, k, "multipart GET")
                                       for b, k in mps], nbytes(mps), n_mp)
        # a ranged read of the first upload's part 2 (the gateway takes
        # no Range header): its RADOS object through the parent's store
        man = store.head_object(*mps[0])["multipart"]
        if [size for _n, size in man["parts"]] != [part] * n_parts:
            raise AssertionError(f"{mps[0]}: manifest {man}")
        got = store.data.read(st_mod._part_oid("b0", man["upload_id"], 2),
                              part // 2, part // 4)
        check(got, parts[mps[0]][1][part // 4:part // 4 + part // 2],
              "ranged read of part 2")
        src = bigs[0]
        copy = ("b1", "copy/" + src[1])

        def copy_object():
            _, bd = req("PUT", f"/{copy[0]}/{copy[1]}", headers={
                "x-amz-copy-source": f"/{src[0]}/{src[1]}"})
            etag = re.search(rb"<ETag>&quot;([^&]+)&quot;</ETag>",
                             bd).group(1).decode()
            if etag != etags[src][1]:
                raise AssertionError(f"copy ETag {etag}")
            want[copy], etags[copy] = want[src], etags[src]
        step("copy_object", copy_object, big, 1)
        # 4. versioning on b1: a key PUT twice, then a delete marker
        vkey = ("b1", "ver/key")
        vbody = [rng.integers(0, 256, sizes["version"], dtype=np.uint8)
                 for _ in range(2)]

        def versions():
            _, bd = req("GET", "/b1", "versions")
            return [(tag, k, v, latest == "true", int(size))
                    for tag, k, v, latest, size in re.findall(
                        r"<(Version|DeleteMarker)><Key>([^<]*)</Key>"
                        r"<VersionId>([^<]*)</VersionId><IsLatest>"
                        r"(true|false)</IsLatest><Size>(\d+)</Size>",
                        bd.decode())]

        def get_versions(rows, what):
            for (_tag, k, vid, _l, _s), data in zip(
                    [r for r in rows if r[0] == "Version"], vbody[::-1]):
                _, bd = req("GET", f"/b1/{k}", f"versionId={vid}")
                check(bd, data, f"{what}: version {vid}")

        def versioning():
            req("PUT", "/b1", "versioning", b"<VersioningConfiguration>"
                b"<Status>Enabled</Status></VersioningConfiguration>")
            for data in vbody:
                put(*vkey, data)
            rows = versions()
            if [(t, latest, size) for t, _k, _v, latest, size in rows] != \
                    [("Version", True, vbody[1].size),
                     ("Version", False, vbody[0].size)]:
                raise AssertionError(f"versions {rows}")
            get_versions(rows, "versioned GET")
            req("DELETE", f"/b1/{vkey[1]}", ok=204)
            req("GET", f"/b1/{vkey[1]}", ok=404)
            want.pop(vkey)
            etags.pop(vkey)
            rows = versions()
            if [(t, latest) for t, _k, _v, latest, _s in rows] != \
                    [("DeleteMarker", True), ("Version", False),
                     ("Version", False)]:
                raise AssertionError(f"versions after DELETE {rows}")
            get_versions(rows, "version under a delete marker")
            out["versions"] = [(t, k, latest, size)
                               for t, k, _v, latest, size in rows]
        step("versioning", versioning, 2 * 2 * sizes["version"], 9)
        # 4b. a lifecycle rule expiring tmp/ on b2 after a day
        tmps = [("b2", f"tmp/t{i}") for i in range(n_lc)]
        body = {k: rng.integers(0, 256, lc_size, dtype=np.uint8)
                for k in tmps}

        def lifecycle():
            req("PUT", "/b2", "lifecycle", (
                b"<LifecycleConfiguration><Rule><ID>tmp</ID>"
                b"<Prefix>tmp/</Prefix><Status>Enabled</Status>"
                b"<Expiration><Days>1</Days></Expiration></Rule>"
                b"</LifecycleConfiguration>"))
            for b, k in tmps:
                put(b, k, body[(b, k)])
            swept = store.lifecycle_sweep(now=time.time() + 2 * DAY_S)
            if swept["expired"] != n_lc:
                raise AssertionError(f"lifecycle swept {swept}")
            for b, k in tmps:
                req("GET", f"/{b}/{k}", ok=404)
                if not gone(st_mod._data_oid(b, k)):
                    raise AssertionError(f"lifecycle left {b}/{k}'s data")
                want.pop((b, k))
                etags.pop((b, k))
            out["lifecycle"] = swept
        step("lifecycle", lifecycle, n_lc * lc_size, 2 * n_lc + 1)
        # 5. listings: with a delimiter and flat, in pages; b3 resharded
        listings = out["listings"] = {}

        def list_all(tag, reader):
            for b in buckets:
                for d in ("/", ""):
                    pages = listings[(tag, b, d)] = reader(b, d, page)
                    keys = [k for p in pages for k in p[0]]
                    cps = [c for p in pages for c in p[1]]
                    if (keys, cps) != expected_listing(etags, b, d):
                        raise AssertionError(f"{tag}: {b} lists {keys}, "
                                             f"{cps}")
        step("list", lambda: list_all(
            "before", lambda b, d, n: s3_listing(s3[0], b, d, n)), 0,
            2 * len(buckets))
        step("reshard", lambda: store.reshard_bucket(
            "b3", sizes["reshard"]), 0, 1)
        if store.index.read_layout("b3").shards != sizes["reshard"]:
            raise AssertionError(f"b3: {store.reshard_status('b3')}")

        def relist():
            for tag, reader in (("gateway", lambda b, d, n: s3_listing(
                    s3[0], b, d, n)), ("store", lambda b, d, n:
                                       store_listing(store, b, d, n))):
                for d in ("/", ""):
                    pages = listings[(tag, "b3", d)] = reader("b3", d, page)
                    flat = [[k for p in pages for k in p[0]],
                            [c for p in pages for c in p[1]]]
                    before = listings[("before", "b3", d)]
                    if flat != [[k for p in before for k in p[0]],
                                [c for p in before for c in p[1]]]:
                        raise AssertionError(f"b3 after the reshard "
                                             f"({tag}, {d!r}): {flat}")
        step("list_after_reshard", relist, 0, 4)
        # 6. Swift on the same objects
        swift = ("sw0", "obj.bin")
        sbody = rng.integers(0, 256, sizes["swift"], dtype=np.uint8)

        def swift_io():
            st, hd, _ = s3[0].request("GET", "/auth/v1.0", headers={
                "X-Auth-User": RGW_ACCESS, "X-Auth-Key": RGW_SECRET},
                sign=False)
            out["responses"].append(("GET", "/auth/v1.0", "", st, None))
            if st != 200:
                raise AssertionError(f"swift auth: {st}")
            url, tok = hd["X-Storage-Url"], {"X-Auth-Token":
                                             hd["X-Auth-Token"]}
            for path, data, ok in ((f"{url}/{swift[0]}", b"", 201),
                                   (f"{url}/{swift[0]}/{swift[1]}",
                                    sbody.tobytes(), 201)):
                st, hd, bd = s3[0].request("PUT", path, body=data,
                                           headers=tok, sign=False)
                out["responses"].append(("PUT", path, "", st,
                                         hd.get("ETag")))
                if st != ok:
                    raise AssertionError(f"swift PUT {path}: {st} {bd!r}")
            want[swift] = sbody
            etags[swift] = (sbody.size, hashlib.md5(
                sbody.tobytes()).hexdigest())
            get(*swift, "swift object through S3")
            st, _, bd = s3[0].request("GET", f"{url}/{src[0]}/{src[1]}",
                                      headers=tok, sign=False)
            if st != 200:
                raise AssertionError(f"swift GET: {st}")
            check(bd, want[src], "S3 object through swift")
        step("swift", swift_io, 2 * sizes["swift"] + big, 5)
        # 7. the OSD of data shard 1 of the first big object down
        whole = bigs + [copy] + mps
        victim = out["victim"] = kill_shard_holder(
            c, store.data, st_mod._data_oid(*bigs[0]))
        step("get_degraded", lambda: get_all(whole, "degraded GET"),
             nbytes(whole), len(whole))

        def revive():
            c.revive_osd(victim)
            revived(victim)
            c.wait_active_clean(timeout=PROC_CLEAN_TIMEOUT_S)
        step("revive_to_clean", revive, 0)
        step("get_after_revive", lambda: get_all(whole, "GET after the "
                                                 "revive"),
             nbytes(whole), len(whole))
        # 8. the gateway killed and started again: its state is in RADOS
        before = {k: v for k, v in listings.items() if k[0] == "before"}
        rows = out["versions"]

        def restart():
            s3[0] = S3Client(restart_gateway(), sigv4)
        step("gateway_restart", restart, 0, 1)

        def after_restart():
            _, bd = req("GET", "/")
            names = re.findall(r"<Name>([^<]*)</Name>", bd.decode())
            if sorted(names) != sorted(buckets + [swift[0]]):
                raise AssertionError(f"buckets after the restart {names}")
            for (_t, b, d), pages in before.items():
                now = s3_listing(s3[0], b, d, page)
                if b != "b3" and now != pages:
                    raise AssertionError(f"{b} lists {now} after the "
                                         f"gateway restart")
                if b == "b3" and now != listings[("gateway", b, d)]:
                    raise AssertionError(f"b3 lists {now} after the "
                                         f"gateway restart")
            if [(t, k, latest, size) for t, k, _v, latest, size in
                    versions()] != rows:
                raise AssertionError("versions after the gateway restart")
            get_all(sorted(want), "GET after the gateway restart")
        step("read_after_restart", after_restart, nbytes(want), len(want))
        # 9. notifications and a second zone, through a store with a
        # mod-log in the parent
        src = st_mod.RGWStore(client, modlog=True)
        nm = src.enable_notifications(push_interval=0.1)
        rx = EventReceiver()
        try:
            nm.create_topic("chip", rx.url)
            src.create_bucket("n0")
            nm.put_bucket_notification("n0", [{
                "id": "created", "topic": "chip",
                "events": ["s3:ObjectCreated:*"]}])
            dst = st_mod.RGWStore(zone_b)
            rep = sync_mod.ZoneReplayer(src, dst, "zone-b")
            out["full_sync"] = {}
            step("full_sync", lambda: out["full_sync"].update(
                objects=rep.full_sync()), nbytes(want), len(want))
            events = [("n0", f"e{i}") for i in range(n_ev)]
            for k in events:
                want[k] = rng.integers(0, 256, ev_size, dtype=np.uint8)
                etags[k] = (ev_size, hashlib.md5(
                    want[k].tobytes()).hexdigest())
            step("put_notify", lambda: [src.put_object(
                b, k, want[(b, k)].tobytes()) for b, k in events],
                nbytes(events), n_ev)
            step("sync_once", lambda: out["full_sync"].update(
                entries=rep.sync_once()), nbytes(events), n_ev)
            deadline = time.time() + RGW_EVENT_WAIT_S
            seen = set()
            while len(seen) < n_ev:
                if time.time() > deadline:
                    raise AssertionError(f"{len(seen)} of {n_ev} events "
                                         f"in {RGW_EVENT_WAIT_S} s")
                time.sleep(0.1)
                seen = {(r["eventName"], r["s3"]["bucket"]["name"],
                         r["s3"]["object"]["key"], r["s3"]["object"]["size"])
                        for r in rx.records}
            if seen != {("s3:ObjectCreated:Put", b, k, ev_size)
                        for b, k in events}:
                raise AssertionError(f"events {sorted(seen)}")
            out["events"] = sorted(seen)
            out["event_records"] = len(rx.records)
        finally:
            nm.shutdown()
            rx.close()
        zs = {}
        step("zone_compare", lambda: zs.update(
            src=zone_state(src), dst=zone_state(dst)), 2 * nbytes(want),
            len(want))
        if zs["dst"] != zs["src"]:
            raise AssertionError("the second zone differs from the first")
        for (b, k), data in want.items():
            if zs["src"][b]["objects"][k] != hashlib.sha256(
                    data.tobytes()).hexdigest():
                raise AssertionError(f"zone state of {b}/{k}")
            if "multipart" in dst.head_object(b, k):
                raise AssertionError(f"{b}/{k} arrived as a multipart")
        out["zone"] = zs["src"]
        out["manifests"] = {f"{b}/{k}": store.head_object(b, k)[
            "multipart"]["parts"] for b, k in mps}
        out["data_oids"] = sorted(st_mod._data_oid(b, k) for b, k in want
                                  if (b, k) not in mps)
    finally:
        pool.shutdown()
    out["responses"].sort(key=repr)
    out["listings"] = sorted(out["listings"].items())
    return out


def start_gateway(mon: str, log: Path, profile: str):
    """The `radosgw` entry point (python -m ceph_tpu_torch.rgw.gateway) as
    a process: SigV4 with RGW_ACCESS / RGW_SECRET, the data pool's EC
    profile `profile`, the port it bound from its first line.
    Returns (the process, its address)."""
    import re
    import select
    here = os.path.dirname(os.path.abspath(__file__))
    with open(log, "ab") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.rgw.gateway", "-m", mon,
             "--port", "0", "--ec-profile", profile, "--access-key",
             RGW_ACCESS, "--secret", RGW_SECRET], cwd=here,
            stdout=subprocess.PIPE, stderr=err)
    buf, deadline = b"", time.time() + RGW_BOOT_TIMEOUT_S
    while time.time() < deadline:
        m = re.search(rb"radosgw listening on \('[^']*', (\d+)\)", buf)
        if m:
            return proc, ("127.0.0.1", int(m.group(1)))
        if proc.poll() is not None:
            raise AssertionError(f"the gateway exited {proc.returncode}: "
                                 f"{log.read_bytes()[-4000:]!r}")
        r, _, _ = select.select([proc.stdout], [], [], 0.2)
        if r:
            buf += os.read(proc.stdout.fileno(), 4096)
    proc.kill()
    raise AssertionError(f"the gateway was not ready in "
                         f"{RGW_BOOT_TIMEOUT_S} s")


def object_service_run(device: str, root, cache_dir) -> dict:
    """Phase P on one process cluster over BlueStore: the data pool made
    first, the gateway a process, object_sequence through it and through
    stores in the parent, a second zone an in-process cluster on
    `device` with its own torch k=8 m=3 `.rgw.data`; then the `rgw`
    role of daemon_main (ProcCluster.spawn_rgw) serves a bucket, an
    object and a GET.  Each step's launches are read through the
    daemons' `launch profile`, as phase M's are; the second zone's
    through the kernel wrappers' counts in this process."""
    import types
    import urllib.request

    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.rgw import sigv4
    from ceph_tpu_torch.rgw import store as st_mod
    from ceph_tpu_torch.rgw import sync as sync_mod
    from ceph_tpu_torch.tools.proc_cluster import ProcCluster
    from ceph_tpu_torch.tools.vstart import Cluster
    asok_dir = root / "asok"
    asok_dir.mkdir(parents=True)
    report = {"osds": N_RGW_OSDS, "zone_b_osds": RGW_ZONE_B_OSDS,
              "steps": {}, "launches": {}, "zone_b_launches": {}}
    c = ProcCluster(n_osds=N_RGW_OSDS, objectstore="bluestore",
                    data_dir=str(root / "data"), asok_dir=str(asok_dir),
                    heartbeat_interval=0.0, prewarm=True,
                    compile_cache_dir=str(cache_dir),
                    boot_timeout=PROC_BOOT_TIMEOUT_S, device=device)
    daemons = ProcDaemons(c, cache_dir)
    on_card = torch.device(device).type == "cuda"
    gw = {}
    zone = {"counts": bs.launch_counts()}

    def step(label, fn, nbytes, ops=0):
        st = report["steps"][label] = timed(fn, nbytes)
        if on_card:
            torch.cuda.synchronize()
        if ops:
            st.update(ops=ops, ops_s=ops / st["wall_s"])
        report["launches"][label] = daemons.read_launches()
        now = bs.launch_counts()
        report["zone_b_launches"][label] = {
            k: now[k] - zone["counts"][k] for k in now}
        zone["counts"] = now
        if gw["proc"].poll() is not None:
            raise AssertionError(f"the gateway exited "
                                 f"{gw['proc'].returncode} in {label}")

    def restart_gateway():
        gw["proc"].kill()
        gw["proc"].wait()
        gw["proc"], addr = start_gateway(mon, root / "rgw.log", name)
        return addr

    name, profile, pg_num = RGW_POOL
    zone_b = None
    t0 = time.perf_counter()
    try:
        c.start()
        report["boot_s"] = time.perf_counter() - t0
        for i in range(N_RGW_OSDS):
            daemons.boot_check(i)
        mon = "%s:%d" % tuple(c.mon_addrs[0])
        cl = c.client()
        cl.set_ec_profile(name, profile)
        cl.create_pool(st_mod.DATA_POOL, "erasure",
                       erasure_code_profile=name, pg_num=pg_num)
        t = time.perf_counter()
        gw["proc"], addr = start_gateway(mon, root / "rgw.log", name)
        report["gateway_boot_s"] = time.perf_counter() - t
        t = time.perf_counter()
        zone_b = Cluster(n_osds=RGW_ZONE_B_OSDS, device=device).start()
        report["zone_b_boot_s"] = time.perf_counter() - t
        zcl = zone_b.client()
        zcl.set_ec_profile(name, profile)
        zcl.create_pool(st_mod.DATA_POOL, "erasure",
                        erasure_code_profile=name, pg_num=pg_num)
        c.wait_active_clean(timeout=PROC_CLEAN_TIMEOUT_S)
        daemons.read_launches()
        zone["counts"] = bs.launch_counts()
        res = object_sequence(
            addr, types.SimpleNamespace(sigv4=sigv4, store=st_mod,
                                        sync=sync_mod),
            cl, c, daemons.boot_check, restart_gateway, zcl, RGW_SIZES,
            step)
        report.update({k: res[k] for k in (
            "victim", "versions", "lifecycle", "full_sync", "events",
            "event_records", "manifests")})
        report["responses"] = len(res["responses"])
        report["zone_objects"] = {b: len(v["objects"])
                                  for b, v in res["zone"].items()}
        # 10. the rgw role of daemon_main, through ProcCluster.spawn_rgw
        t = time.perf_counter()
        host, port = c.spawn_rgw()
        base = f"http://{host}:{port}"
        for path, data in (("/pbucket", None), ("/pbucket/k", b"procdata")):
            with urllib.request.urlopen(urllib.request.Request(
                    base + path, data=data, method="PUT"), timeout=60) as r:
                if r.status != 200:
                    raise AssertionError(f"rgw role PUT {path}: {r.status}")
        with urllib.request.urlopen(base + "/pbucket/k", timeout=60) as r:
            if r.read() != b"procdata":
                raise AssertionError("rgw role GET")
        report["rgw_role_s"] = time.perf_counter() - t
        report["launches"]["rgw_role"] = daemons.read_launches()
        if gw["proc"].poll() is not None:
            raise AssertionError(f"the gateway exited "
                                 f"{gw['proc'].returncode}")
    finally:
        if gw.get("proc") is not None:
            gw["proc"].kill()
            gw["proc"].wait()
        if zone_b is not None:
            zone_b.stop()
        c.stop()
    report["launch_totals"] = daemons.totals
    report["zone_b_totals"] = {}
    for counts in report["zone_b_launches"].values():
        for k, n in counts.items():
            report["zone_b_totals"][k] = report["zone_b_totals"].get(
                k, 0) + n
    return report


def phase_object_service(tmp) -> tuple[dict, dict, dict]:
    """Phase P: the object service on the card, in a process cluster of
    its own whose daemons load the library the parent built, and a
    second zone in this process.  Returns (the daemons' launch counts,
    the second zone's, the report)."""
    from ceph_tpu_torch.ops import _build
    root = tmp / "rgw"
    cache_dir = root / "cache"
    cache_dir.mkdir(parents=True)
    shutil.copy2(_build.library_path(), cache_dir)
    res = object_service_run("cuda", root, cache_dir)
    total, zone_b = res["launch_totals"], res["zone_b_totals"]
    missing = [k for k in ("fused_hier_acc_call", "gf_encode_with_crc_w32",
                           "gf_bitmatmul") if total.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase P missed kernels {missing}: {total}")
    if zone_b.get("fused_hier_acc_call", 0) <= 0:
        raise AssertionError(f"phase P's second zone launched no K3: "
                             f"{zone_b}")
    res["card"] = nvidia_smi_line()
    print(f"# object service ({res['card']}): boot {res['boot_s']:.2f} s, "
          f"gateway {res['gateway_boot_s']:.2f} s, second zone "
          f"{res['zone_b_boot_s']:.2f} s; "
          + "; ".join(f"{k} {v['GBps']:.4f} GB/s"
                      + (f" {v['ops_s']:.1f} op/s" if v.get("ops") else "")
                      + f" ({v['wall_s']:.3f} s)"
                      for k, v in res["steps"].items())
          + f"; events {res['event_records']}; launches {total}; second "
          f"zone {zone_b}", flush=True)
    return total, zone_b, res


# Phase Q: the load harness and the deployer (tools/load_harness.py,
# tools/deploy.py) through their entry points, at Octopus's shapes: k=8
# m=3 torch pools (K3 pinned), 4 MiB objects (RBD's default object
# size), stripe unit 4096 B but where the harness fixes its own.  Q1 the
# virtual-time QoS sims as the CLI runs them; Q2 the many-PG write sweep
# (1 -> 8 -> 64 PGs on one launch queue, as bench.py runs it) in this
# process; Q3 the degraded-read storm (12 OSDs, 16 x 4 MiB) and Q4 mixed
# rados / S3 / RBD traffic on a 12-OSD cluster, each in a child process
# whose library comes from the run's cache directory; Q5 `deploy apply`
# of the deployer's own example spec on Octopus's default BlueStore.
HARNESS_CHILD_TIMEOUT_S = 600
Q_PG_SWEEP = {"pg_counts": (1, 8, 64), "total_objs": 128, "objsize": BIG,
              "chunk": STRIPE_UNIT, "passes": 1}
Q_STORM = {"n_osds": 12, "objects": 16, "size": BIG, "cycles": 1,
           "read_passes": 3}
N_MIXED_OSDS = 12
MIXED_POOL = ("hl_k8m3", PROC_POOL[1], 16)
MIXED_ROWS = {
    # closed loop: 16 clients over 64 Zipf-hot 4 MiB objects
    "rados_closed": {"clients": 16, "n_objects": 64, "size": BIG,
                     "read_frac": 0.5, "zipf_alpha": 1.1, "seconds": 5.0},
    # open loop, the harness's burst shape: 200 sessions at 10/s each,
    # 4x bursts on 5 ops of every 20, 64 KiB objects
    "rados_open": {"clients": 8, "sessions_per_client": 25, "rate": 10.0,
                   "burst_factor": 4.0, "burst_every": 20, "burst_len": 5,
                   "n_objects": 64, "size": SMALL, "read_frac": 0.5,
                   "zipf_alpha": 1.1, "seconds": 5.0},
    "s3": {"clients": 8, "n_objects": 32, "size": BIG, "seconds": 5.0},
    "rbd": {"clients": 4, "seconds": 3.0},
}
DEPLOY_SPEC = {"mons": 1, "osds": 12, "objectstore": "bluestore",
               "mds": ["a"], "rgw": 1}
DEPLOY_POOL = ("deploy_k8m3", PROC_POOL[1], 16)
N_DEPLOY_OBJECTS = 16
DEPLOY_OBJECT = BIG
DEPLOY_TIMEOUT_S = 600
DEPLOY_CLEAN_TIMEOUT_S = 300.0


def harness_sims() -> dict:
    """Q1: `load_harness --scenario qos-sim` and `qos-sim-recovery` as
    processes; each must exit 0 with its victim isolated."""
    here = os.path.dirname(os.path.abspath(__file__))
    rows = {}
    for scenario in ("qos-sim", "qos-sim-recovery"):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.load_harness",
             "--scenario", scenario], capture_output=True, text=True,
            cwd=here, timeout=120)
        if proc.returncode != 0:
            raise AssertionError(f"load_harness {scenario} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        if row["isolated"] is not True:
            raise AssertionError(f"{scenario}: not isolated: {row}")
        row["wall_s"] = time.perf_counter() - t
        rows[scenario] = row
    return rows


def harness_pg_sweep(device: str) -> tuple[dict, dict]:
    """Q2: run_ec_pg_sweep in this process, as bench.py calls it; every
    object acked (the sweep raises otherwise), a launch that coalesced
    PGs and more than one run a launch.  Returns (its launch counts, the
    row)."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.tools import load_harness
    bs.reset_launch_counts()
    t = time.perf_counter()
    row = load_harness.run_ec_pg_sweep(**Q_PG_SWEEP, min_frac=0.0,
                                       device=device)
    row["wall_s"] = time.perf_counter() - t
    counts = bs.launch_counts()
    if not row["ok"] or row["cross_pg_launches"] < 1 or \
            row["runs_per_launch"] <= 1.0:
        raise AssertionError(f"ec-pg-sweep: {row}")
    return counts, row


def harness_storm(device: str) -> dict:
    """Q3's traffic: run_degraded_read_storm and the launches it made.
    The row must be `ok`, lose no acked byte, read nothing wrong and
    rebuild at least one read."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.tools import load_harness
    bs.reset_launch_counts()
    t = time.perf_counter()
    row = load_harness.run_degraded_read_storm(**Q_STORM, device=device)
    row["wall_s"] = time.perf_counter() - t
    row["launches"] = bs.launch_counts()
    if not row.get("ok") or not row.get("zero_acked_loss") or \
            row.get("mismatches") or row.get("reconstruct_reads", 0) < 1:
        raise AssertionError(f"degraded-read storm: {row}")
    return row


def harness_mixed(device: str, cache_dir) -> dict:
    """Q4's traffic on one in-process cluster: a torch k=8 m=3 pool and
    `.rgw.data` of the same profile made before the gateway starts, then
    run_rados_mixed closed-loop and open-loop, run_s3_mixed and
    run_rbd_mixed (on a replicated pool, as the harness's main does).
    Every row must have 0 errors and ops; each row's launches are read
    after it."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.tools import load_harness as lh
    from ceph_tpu_torch.tools.vstart import Cluster
    name, profile, pg_num = MIXED_POOL
    report = {"osds": N_MIXED_OSDS, "rows": {}, "launches": {}}
    t = time.perf_counter()
    with Cluster(n_osds=N_MIXED_OSDS, device=device,
                 compile_cache_dir=str(cache_dir)) as c:
        report["boot_s"] = time.perf_counter() - t
        client = c.client()
        client.set_ec_profile(name, profile)
        for pool in (name, ".rgw.data"):
            client.create_pool(pool, "erasure", erasure_code_profile=name,
                               pg_num=pg_num)
        client.create_pool("hl_rbd", "replicated", size=3, pg_num=16)
        runs = {
            "rados_closed": lambda s: lh.run_rados_mixed(c, client, name, s),
            "rados_open": lambda s: lh.run_rados_mixed(c, client, name, s),
            "s3": lambda s: lh.run_s3_mixed(c, client, s),
            "rbd": lambda s: lh.run_rbd_mixed(c, client, "hl_rbd", s)}
        for label, run in runs.items():
            if label == "rados_open":
                # both rados rows write `h_<i>`: a write_full over an
                # object that exists re-encodes it whole (K1), so the
                # closed loop's objects go first and the open loop's
                # 64 KiB objects are made afresh (K2's flat entry)
                io = client.open_ioctx(name)
                for i in range(MIXED_ROWS["rados_closed"]["n_objects"]):
                    io.remove(f"h_{i}")
            bs.reset_launch_counts()
            t = time.perf_counter()
            row = run(lh.WorkloadSpec(**MIXED_ROWS[label]))
            row["wall_s"] = time.perf_counter() - t
            report["launches"][label] = bs.launch_counts()
            if row["errors"] or not row["ops"]:
                raise AssertionError(f"{label}: {row['ops']} ops, errors "
                                     f"{row['errors_by_type']}")
            report["rows"][label] = row
    return report


def harness_child(mode: str, cache_dir: str) -> int:
    """Q3 (`storm`) or Q4 (`mixed`) in its own process on the card: the
    kernel library cache points at `cache_dir` before the library's
    first load.  Prints one JSON line."""
    from ceph_tpu_torch.ops import compile_cache
    compile_cache.enable(cache_dir)
    report = harness_storm("cuda") if mode == "storm" else \
        harness_mixed("cuda", cache_dir)
    report["compile_cache_after"] = compile_cache.status()
    print(json.dumps(report, default=str), flush=True)
    return 0


def run_harness_child(mode: str, cache_dir) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--harness-child", mode,
         str(cache_dir)], capture_output=True, text=True,
        timeout=HARNESS_CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"harness {mode} exited {proc.returncode}:\n"
                             f"{proc.stderr[-6000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    lib = res["compile_cache_after"]["kernel_library"]
    if lib["builds_in_process"] or not res["compile_cache_after"]["enabled"]:
        raise AssertionError(f"harness {mode} did not load the cached "
                             f"library: {res['compile_cache_after']}")
    return res


def deploy_run(device: str, root, cache_dir) -> dict:
    """Q5: `deploy apply` of DEPLOY_SPEC (a mon, 12 OSDs on BlueStore, an
    MDS and a gateway, booted one at a time, the library from
    `cache_dir`); `ls` shows every unit running; a torch k=8 m=3 pool
    through the mon of monmap.json, 16 x 4 MiB written; `stop` of the
    OSD of data shard 1 of the first object, every object read
    degraded; a PUT and a GET of 4 MiB through rgw.0; `start` of the
    OSD, active+clean, every object read; `rm-cluster` leaves no live
    pid and no directory.  The deployed daemons serve no admin socket,
    so no launch is counted here: the reads, equal to the bytes written,
    and the units' `--device` are what show the work."""
    import urllib.request

    from ceph_tpu_torch.rados.client import RadosClient
    from ceph_tpu_torch.tools.deploy import _alive
    from ceph_tpu_torch.tools.proc_cluster import ProcCluster
    here = os.path.dirname(os.path.abspath(__file__))
    cdir = root / "cluster"
    root.mkdir(parents=True, exist_ok=True)
    spec_file = root / "spec.json"
    spec_file.write_text(json.dumps(DEPLOY_SPEC))
    env = dict(os.environ, CEPH_TPU_TORCH_COMPILE_CACHE=str(cache_dir))
    report = {"spec": DEPLOY_SPEC, "steps": {}}
    rng = np.random.default_rng(SEED + 19)

    def deploy(*argv):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.deploy", *argv,
             "--dir", str(cdir)], capture_output=True, text=True, cwd=here,
            env=env, timeout=DEPLOY_TIMEOUT_S)
        if proc.returncode != 0:
            logs = "".join(
                f"\n{p.name}: {p.read_bytes()[-1500:]!r}"
                for p in sorted(cdir.glob("*.log")))
            raise AssertionError(f"deploy {argv} exited {proc.returncode}:"
                                 f"\n{proc.stderr[-4000:]}{logs}")
        return proc.stdout, time.perf_counter() - t

    def units() -> dict:
        out, _ = deploy("ls")
        return {u["name"]: u for u in map(json.loads, out.splitlines())}

    class Deployed:
        """The deployed cluster as ProcCluster's clean-state probe reads
        one: the mon's map and `pg stat` against every OSD unit's
        address."""
        _active_clean_once = ProcCluster._active_clean_once
        wait_active_clean = ProcCluster.wait_active_clean

        def __init__(self, client):
            self.client = client
            self.osd_procs, self.osd_addrs = [], {}

        def admin(self):
            return self.client

        def refresh(self):
            us = units()
            n = DEPLOY_SPEC["osds"]
            self.osd_procs = [us[f"osd.{i}"]["pid"]
                              if us[f"osd.{i}"]["state"] == "running"
                              else None for i in range(n)]
            self.osd_addrs = {}
            for i in range(n):
                host, _, port = us[f"osd.{i}"]["addr"].rpartition(":")
                self.osd_addrs[i] = (host, int(port))

    applied = False
    client = None
    try:
        out, report["apply_s"] = deploy("apply", str(spec_file),
                                        *(["--device", "cpu"]
                                          if device == "cpu" else []))
        applied = True
        rgw = next(ln.split()[-1] for ln in out.splitlines()
                   if ln.startswith("rgw.0 serving at "))
        us = units()
        report["units"] = {k: u["state"] for k, u in us.items()}
        want = {"mon.0", "mds.a", "rgw.0",
                *(f"osd.{i}" for i in range(DEPLOY_SPEC["osds"]))}
        if set(us) != want or any(u["state"] != "running"
                                  for u in us.values()):
            raise AssertionError(f"deploy ls: {report['units']}")
        pids = [u["pid"] for u in us.values()]
        for name, u in us.items():
            argv = json.loads((cdir / "units" / f"{name}.json")
                              .read_text())["argv"]
            has = argv[-2:] == ["--device", device]
            if has != (name.split(".")[0] in ("mon", "osd")):
                raise AssertionError(f"{name}'s unit argv {argv}")
        mons = json.loads((cdir / "monmap.json").read_text())["mons"]
        client = RadosClient([(h, int(p)) for h, _, p in
                              (m.rpartition(":") for m in mons)]).connect()
        cluster = Deployed(client)
        name, profile, pg_num = DEPLOY_POOL
        client.set_ec_profile(name, profile)
        client.create_pool(name, "erasure", erasure_code_profile=name,
                           pg_num=pg_num)
        io = client.open_ioctx(name)
        expect = {f"q{i}": rng.integers(0, 256, DEPLOY_OBJECT,
                                        dtype=np.uint8)
                  for i in range(N_DEPLOY_OBJECTS)}
        nbytes = len(expect) * DEPLOY_OBJECT

        def read_all(what):
            futs = {}

            def submit(k):
                futs[k] = io.aio_read(k, DEPLOY_OBJECT)
                return futs[k]
            _windowed([lambda k=k: submit(k) for k in expect], PROC_DEPTH)
            for k, v in expect.items():
                check_bytes(futs[k].result(timeout=300), v, f"{what} {k}")

        def step(label, fn, nb):
            report["steps"][label] = timed(fn, nb)

        cluster.refresh()
        step("clean_after_apply", lambda: cluster.wait_active_clean(
            timeout=DEPLOY_CLEAN_TIMEOUT_S), 0)
        step("write", lambda: _windowed(
            [lambda k=k, v=v: io.aio_write_full(k, v.tobytes())
             for k, v in expect.items()], PROC_DEPTH), nbytes)
        objecter = client.objecter
        pgid = objecter._calc_target(io.pool_id, "q0")[0].pgid
        victim = objecter.osdmap.pg_to_up_acting_osds(pgid)[1][1]
        report["victim"] = victim

        def stop():
            deploy("stop", "--name", f"osd.{victim}")
            r, _ = client.mon_command({"prefix": "osd down", "id": victim})
            if r != 0:
                raise AssertionError(f"osd down {victim}: {r}")
            deadline = time.time() + 30
            while objecter.osdmap.is_up(victim):
                if time.time() > deadline:
                    raise AssertionError("the client never saw the down "
                                         "map")
                objecter.refresh_map(timeout=2.0)
        step("stop", stop, 0)
        step("degraded_read", lambda: read_all("degraded read"), nbytes)
        body = rng.integers(0, 256, BIG, dtype=np.uint8)

        def s3():
            req = urllib.request.Request(rgw + "/qbucket", method="PUT")
            urllib.request.urlopen(req, timeout=120).read()
            req = urllib.request.Request(rgw + "/qbucket/big",
                                         data=body.tobytes(), method="PUT")
            urllib.request.urlopen(req, timeout=120).read()
            with urllib.request.urlopen(rgw + "/qbucket/big",
                                        timeout=120) as resp:
                check_bytes(resp.read(), body, "rgw.0 GET")
        step("rgw_put_get", s3, 2 * BIG)

        def start():
            deploy("start", "--name", f"osd.{victim}")
            cluster.refresh()
            cluster.wait_active_clean(timeout=DEPLOY_CLEAN_TIMEOUT_S)
        step("start_to_clean", start, 0)
        step("read_after_start", lambda: read_all("read after start"),
             nbytes)
        client.shutdown()
        client = None
        _, report["rm_cluster_s"] = deploy("rm-cluster")
        applied = False
        time.sleep(0.5)
        alive = [p for p in pids if _alive(p)]
        if alive or cdir.exists():
            raise AssertionError(f"rm-cluster left pids {alive}, directory "
                                 f"{cdir.exists()}")
    finally:
        if client is not None:
            client.shutdown()
        if applied:
            subprocess.run(
                [sys.executable, "-m", "ceph_tpu_torch.tools.deploy",
                 "rm-cluster", "--dir", str(cdir)], capture_output=True,
                cwd=here, env=env, timeout=DEPLOY_TIMEOUT_S)
    return report


def phase_harness(tmp) -> tuple[dict, dict]:
    """Phase Q: the load harness and the deployer on the card.  Returns
    (its launch counts, Q2's, Q3's and Q4's summed; the report)."""
    from ceph_tpu_torch.ops import _build
    root = tmp / "harness"
    cache_dir = root / "cache"
    cache_dir.mkdir(parents=True)
    shutil.copy2(_build.library_path(), cache_dir)
    card = nvidia_smi_line()
    report, walls, total = {"card": card}, {}, {}
    t_q = time.perf_counter()

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    t = time.perf_counter()
    report["sims"] = harness_sims()
    walls["Q1"] = time.perf_counter() - t
    print("# harness Q1 sims: " + "; ".join(
        f"{s} isolated, ratio {r['qos_isolation_ratio']} (no QoS "
        f"{r['no_qos_ratio']}), {r['wall_s']:.2f} s"
        for s, r in report["sims"].items()), flush=True)

    t = time.perf_counter()
    counts, sweep = harness_pg_sweep("cuda")
    walls["Q2"] = time.perf_counter() - t
    add(counts)
    report["pg_sweep"], report["pg_sweep_launches"] = sweep, counts
    print(f"# harness Q2 ec-pg-sweep ({card}): agg GB/s {sweep['agg_GBps']}, "
          f"degradation_frac {sweep['degradation_frac']} (the reference "
          f"gates 0.8; not gated here), launches {sweep['launches']}, "
          f"runs/launch {sweep['runs_per_launch']}, cross-PG "
          f"{sweep['cross_pg_launches']}, occupancy "
          f"{sweep['occupancy_pct']}%; by kernel {counts}", flush=True)

    # Q5's deploy boots its 15 daemons one at a time (about two minutes
    # on the card, mostly each process's start), so it runs beside Q3
    # and Q4, whose clusters live in children of their own: the phase
    # keeps to its share of the script's time
    dep_cache = root / "deploy_cache"
    dep_cache.mkdir()
    shutil.copy2(_build.library_path(), dep_cache)
    q5 = {}

    def deploy_q5():
        t = time.perf_counter()
        try:
            q5["report"] = deploy_run("cuda", root / "deploy", dep_cache)
        except BaseException as e:  # noqa: BLE001 - raised after the join
            q5["error"] = e
        q5["wall_s"] = time.perf_counter() - t
    q5_thread = threading.Thread(target=deploy_q5, name="phase-q5")
    q5_thread.start()

    try:
        t = time.perf_counter()
        storm = run_harness_child("storm", cache_dir)
        walls["Q3"] = time.perf_counter() - t
        add(storm["launches"])
        report["storm"] = storm
        st = storm["stages"]
        print(f"# harness Q3 degraded-read storm ({card}): read p50 "
              f"{storm['read_p50_ms']} p99 {storm['read_p99_ms']} p999 "
              f"{storm['read_p999_ms']} ms over {storm['read_ops']} reads, "
              f"reconstruct_reads {storm['reconstruct_reads']}, ledger "
              f"{storm['degraded_ledger']}, stages "
              + json.dumps({k: st.get(k) for k in ("ec_batch_wait",
                                                   "launch_device",
                                                   "launch_submit")})
              + f", {storm['duration_s']} s; launches {storm['launches']}",
              flush=True)

        t = time.perf_counter()
        mixed = run_harness_child("mixed", cache_dir)
        walls["Q4"] = time.perf_counter() - t
        for counts in mixed["launches"].values():
            add(counts)
        report["mixed"] = mixed
        print(f"# harness Q4 mixed ({card}): boot {mixed['boot_s']:.2f} s; "
              + "; ".join(
                  f"{k} {r['ops']} ops p50 {r['p50_ms']} p99 {r['p99_ms']} "
                  f"p999 {r['p999_ms']} ms ({r['wall_s']:.1f} s) launches "
                  f"{ {n: v for n, v in mixed['launches'][k].items() if v} }"
                  for k, r in mixed["rows"].items()), flush=True)
    finally:
        # the deploy's daemons go before the run's directory does
        q5_thread.join()
    if "error" in q5:
        raise q5["error"]
    walls["Q5 (beside Q3 and Q4)"] = q5["wall_s"]
    dep = report["deploy"] = q5["report"]
    print(f"# harness Q5 deploy ({card}): apply {dep['apply_s']:.2f} s "
          f"(15 units, one at a time, beside Q3 and Q4), victim "
          f"osd.{dep['victim']}; "
          + "; ".join(f"{k} {v['GBps']:.4f} GB/s ({v['wall_s']:.3f} s)"
                      for k, v in dep["steps"].items())
          + f"; rm-cluster {dep['rm_cluster_s']:.2f} s (no launch "
          f"counted: the deployed daemons serve no admin socket)",
          flush=True)

    missing = [k for k in ("fused_hier_acc_call", "gf_encode_with_crc_w32",
                           "gf_bitmatmul") if total.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase Q missed kernels {missing}: {total}")
    report["walls_s"] = walls
    report["launch_totals"] = total
    print(f"# harness walls {json.dumps(walls)}, phase Q "
          f"{time.perf_counter() - t_q:.1f} s; launches {total}", flush=True)
    return total, report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from ceph_tpu_torch import resolve_device
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry, gf
    from ceph_tpu_torch.ops import _build, autotune
    from ceph_tpu_torch.ops import bitsliced as bs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    print(nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    walls, mark = {}, [t0]

    def lap(name: str) -> None:
        """The wall of the phases since the last lap."""
        now = time.perf_counter()
        walls[name] = round(now - mark[0], 1)
        mark[0] = now
    _build.build()
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})", flush=True)
    rng = np.random.default_rng(SEED)

    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": str(K), "m": str(M), "device": str(dev)})
    rows = phase_kernels(dev, bs, gf, rng, codec)
    k3_table = k3_block_table(dev, bs, gf, rng, rows)
    k2_table = k2_block_table(
        bs, torch.cuda.get_device_properties(dev).multi_processor_count,
        k3_table, rows)
    bs._encode_crc_launch.narrow_launches = 0
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    lap("build, kernels, K3 and K2 tables")
    try:
        pin_point(tmp / "pinned_xla.json", dev,
                  dict(autotune.default_point(), combine="xla"))
        counts, perf_xla = phase_main_path(dev, rng, "xla", N_BIG_XLA)
        sweep = phase_sweep(dev, tmp / "sweep.json")
        pin_point(tmp / "pinned_kernel.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        counts_k, perf_kernel = phase_main_path(dev, rng, "kernel",
                                                N_BIG_ACC)
        counts.update(counts_k)
        perf_pick = phase_write_ab(dev, rng, tmp, sweep["best"])
        counts["bytes_write"], perf_bytes = phase_bytes_path(dev, rng)
        counts["bench_encode"], counts["bench_decode"], bench = \
            phase_benchmark()
        counts["w32_sweep"], w32_rows = phase_w32_sweep()
        k1_table = k1_thread_bytes_table(dev, rng)
        counts["clay_repair"], clay = phase_clay_repair(dev, rng)
        lap("2-8 (write paths, A-E, G)")
        pin_point(tmp / "pinned_storm.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        storm_counts, storm = phase_recovery_storm(dev, rng)
        scrub_counts, scrub = phase_deep_scrub(dev, rng)
        counts.update(scrub_counts)
        pin_point(tmp / "pinned_boot.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        boot_report = phase_boot()
        mesh_counts, mesh = phase_mesh(dev, rng)
        lap("H-K")
        pin_point(tmp / "pinned_cluster.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        cluster_counts, cluster = phase_cluster(tmp)
        lap("L")
        pin_point(tmp / "pinned_proc.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        proc_counts, proc = phase_proc_cluster(tmp)
        lap("M")
        pin_point(tmp / "pinned_rbd.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        rbd_counts, rbd = phase_block_service(tmp)
        lap("N")
        pin_point(tmp / "pinned_fs.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        fs_counts, fs_report = phase_file_service(tmp)
        lap("O")
        pin_point(tmp / "pinned_rgw.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        rgw_counts, rgw_zone_counts, rgw_report = phase_object_service(tmp)
        lap("P")
        pin_point(tmp / "pinned_harness.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        harness_counts, harness = phase_harness(tmp)
        lap("Q")
        ab = phase_ab()
        lap("F")
        narrow_launches = bs._encode_crc_launch.narrow_launches
    finally:
        os.environ.pop("CEPH_TPU_AUTOTUNE_CACHE", None)
        shutil.rmtree(tmp, ignore_errors=True)
    held = {row["counter"] for row in rows}
    bench_counts = {}
    for r in fs_report["cluster_bench"]:
        for k, n in r.get("launch_ledger", {}).get("kernel_launches",
                                                   {}).items():
            bench_counts[k] = bench_counts.get(k, 0) + n
    for phase, launched in (("L", cluster_counts), ("M", proc_counts),
                            ("N", rbd_counts), ("O", fs_counts),
                            ("O's cluster_bench", bench_counts),
                            ("P", rgw_counts),
                            ("P's secondary zone", rgw_zone_counts),
                            ("Q", harness_counts)):
        unheld = [k for k, n in launched.items() if n and k not in held]
        if unheld:
            raise AssertionError(f"phase {phase} launched {unheld}, which "
                                 f"no kernel row held against its plain "
                                 f"version")
    for row in rows:
        phase = row.pop("phase")
        counter = row.pop("counter")
        if counter is None:
            # K2's narrow branch: its launches over every phase
            row["launches"] = narrow_launches
            row["recovery_storm_launches"] = None
            row["mesh_launches"] = None
            row["cluster_launches"] = cluster["narrow_launches"]
            # the daemons count K2's entries, not its branches
            row["proc_cluster_launches"] = None
            row["block_service_launches"] = None
            row["file_service_launches"] = None
            row["object_service_launches"] = None
            # phase Q counts K2's entries in its own process and children
            row["harness_launches"] = None
            continue
        row["launches"] = counts[phase][counter]
        row["recovery_storm_launches"] = sum(
            c[counter] for c in storm_counts.values())
        row["mesh_launches"] = sum(c[counter] for c in mesh_counts.values())
        row["cluster_launches"] = cluster_counts[counter]
        row["proc_cluster_launches"] = proc_counts.get(counter, 0)
        row["block_service_launches"] = rbd_counts.get(counter, 0)
        row["file_service_launches"] = fs_counts.get(counter, 0)
        row["object_service_launches"] = rgw_counts.get(counter, 0) + \
            rgw_zone_counts.get(counter, 0)
        row["harness_launches"] = harness_counts.get(counter, 0)
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on its "
                                 f"phase ({phase})")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"k3_table": k3_table}), flush=True)
    print(json.dumps({"k2_table": k2_table}), flush=True)
    print(json.dumps({"sweep": sweep}), flush=True)
    print(json.dumps({"main_path_xla": perf_xla}), flush=True)
    print(json.dumps({"main_path_kernel": perf_kernel,
                      "write_ab": perf_pick}), flush=True)
    print(json.dumps({"main_path_bytes": perf_bytes}), flush=True)
    print(json.dumps({"ec_benchmark": bench, "launch_counts": counts}),
          flush=True)
    print(json.dumps({"w32_sweep": w32_rows, "k1_thread_bytes": k1_table}),
          flush=True)
    print(json.dumps({"clay_repair": clay}), flush=True)
    print(json.dumps({"recovery_storm": storm,
                      "recovery_storm_launch_counts": storm_counts}),
          flush=True)
    print(json.dumps({"deep_scrub": scrub,
                      "deep_scrub_launch_counts": scrub_counts}),
          flush=True)
    print(json.dumps({"boot": boot_report}), flush=True)
    print(json.dumps({"mesh": mesh, "mesh_launch_counts": mesh_counts}),
          flush=True)
    print(json.dumps({"cluster": cluster}), flush=True)
    print(json.dumps({"proc_cluster": proc}), flush=True)
    print(json.dumps({"block_service": rbd}), flush=True)
    print(json.dumps({"ec_benchmark_ab": ab}), flush=True)
    bench = fs_report.pop("cluster_bench")
    print(json.dumps({"file_service": fs_report, "cluster_bench": bench}),
          flush=True)
    print(json.dumps({"object_service": rgw_report}), flush=True)
    print(json.dumps({"harness": harness}, default=str), flush=True)
    print(f"# phase walls (s): {json.dumps(walls)}", flush=True)
    print(json.dumps({"phase_walls_s": walls}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--boot-child":
        sys.exit(boot_child(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--cluster-child":
        sys.exit(cluster_child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--harness-child":
        sys.exit(harness_child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
