"""Command-line tools of the port: `ec_benchmark` (the reference's
ceph_erasure_code_benchmark on the torch plugin), `fused_tile_sweep`
(the autotuner's sweep table), `vstart` (an in-process dev cluster: a
mon and N OSD daemons on loopback), `crushtool` (compile, decompile
and test CRUSH map text) and the `rados` and `rbd` clients
(`rados_cli`, `rbd_cli`)."""
