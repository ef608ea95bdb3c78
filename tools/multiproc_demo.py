"""Two-process jax.distributed demo of the compact sharded engine.

The reference's multi-host seam is real processes on real machines —
``mpirun -n N -hostfile`` workers (src/run_distributed_search.py:74-85)
and ssh-dispatched jobs (src/image_search_server.cc:58-83). This demo
runs on the CPU by design, on one host: TWO OS processes, each owning 4
virtual CPU devices, joined by ``jax.distributed.initialize`` into one
8-device global mesh. Everything that breaks across hosts if untested
breaks here first: device_put to non-addressable devices, host pulls of
non-addressable shards, per-process shard persistence, cross-process
barriers.

The demo (driven from the launcher process, which writes a JSON artifact):

  1. build a compact sharded index on mesh (table=4, shard=2, query=1)
     across both processes (200k clustered 128-bit codes),
  2. run the fused sharded search (radius collectives + scan tiers),
  3. assert distance-multiset equality + id->dist cross-check against a
     process-local brute-force oracle,
  4. save per-process shards to a shared directory, barrier, reload, and
     re-run the search on the loaded index (checkpoint/resume seam).

Usage:
  python tools/multiproc_demo.py                 # launcher: spawns workers
  python tools/multiproc_demo.py --out OUT.json  # custom artifact path
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_CODES = 200_000
N_QUERIES = 64
KNN = 10
COORD_PORT = 45677


def worker(proc: int, nprocs: int, save_dir: str, out: str):
    import jax
    jax.config.update("jax_platforms", "cpu")  # CPU by design, see above
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{COORD_PORT}",
        num_processes=nprocs, process_id=proc)
    import jax.numpy as jnp  # noqa: F401
    from jax.experimental import multihost_utils

    from verticut_tpu import codes
    from verticut_tpu.config import MIHConfig, SearchConfig
    from verticut_tpu.parallel import make_mesh
    from verticut_tpu.search.linear import linear_search
    from verticut_tpu.search.sharded_compact import (
        build_sharded_compact, load_sharded_compact, save_sharded_compact,
        sharded_compact_search)

    assert jax.process_count() == nprocs
    n_local = jax.local_device_count()
    n_global = jax.device_count()
    assert n_global == nprocs * n_local, (n_global, nprocs, n_local)
    t_all = time.time()

    cfg = MIHConfig(bits=128, n_tables=4)
    mesh = make_mesh(cfg.n_tables, n_global // cfg.n_tables, 1)
    # identical host-side corpus in every process (deterministic seed) —
    # the build shards it by id across the global mesh
    packed = np.asarray(codes.clustered_codes(
        0, N_CODES, cfg.bits, n_clusters=N_CODES // 200, flip_p=0.02))
    rng = np.random.default_rng(5)
    sel = rng.integers(0, N_CODES, N_QUERIES)
    qraw = codes.unpack_to_bytes(packed[sel])
    flips = rng.integers(0, cfg.bits, (N_QUERIES, 3))
    for i in range(N_QUERIES):
        for b in flips[i]:
            qraw[i, b // 8] ^= 1 << (b % 8)
    queries = codes.pack_bytes(qraw)

    t0 = time.time()
    index = build_sharded_compact(packed, cfg, mesh)
    build_s = time.time() - t0

    scfg = SearchConfig(knn=KNN, candidate_cap=4096, max_enum_radius=5)
    t0 = time.time()
    res = sharded_compact_search(index, queries, scfg)
    search_s = time.time() - t0

    # process-local oracle (no collectives): exact top-k per query
    od, oi = linear_search(queries, packed, KNN, method="popcount")
    od, oi = np.asarray(od), np.asarray(oi)
    multiset_ok = bool(np.array_equal(np.sort(res.dists, axis=-1),
                                      np.sort(od, axis=-1)))
    # id->dist cross-check: every returned id's true distance matches
    qb = np.unpackbits(
        codes.unpack_to_bytes(np.asarray(queries)), axis=-1)
    rb = np.unpackbits(codes.unpack_to_bytes(
        packed[np.clip(res.ids, 0, N_CODES - 1)].reshape(-1, cfg.n_words)
    ), axis=-1).reshape(N_QUERIES, KNN, -1)
    true_d = (qb[:, None, :] != rb).sum(-1)
    id_dist_ok = bool(np.all((res.ids < 0) | (true_d == res.dists)))

    # persistence seam: each process writes ONLY its addressable shards
    save_sharded_compact(save_dir, index)
    multihost_utils.sync_global_devices("multiproc-demo-saved")
    index2 = load_sharded_compact(save_dir, mesh)
    res2 = sharded_compact_search(index2, queries, scfg)
    reload_ok = bool(np.array_equal(res2.dists, res.dists)
                     and np.array_equal(res2.ids, res.ids))
    multihost_utils.sync_global_devices("multiproc-demo-done")

    if proc == 0:
        files = sorted(os.listdir(save_dir))
        payload = {
            "metric": "multiproc_compact_demo",
            "ok": bool(multiset_ok and id_dist_ok and reload_ok),
            "n_processes": nprocs,
            "local_devices_per_process": n_local,
            "global_devices": n_global,
            "mesh": {"table": mesh.shape["table"],
                     "shard": mesh.shape["shard"],
                     "query": mesh.shape["query"]},
            "n_codes": N_CODES,
            "n_queries": N_QUERIES,
            "knn": KNN,
            "oracle_multiset_equal": multiset_ok,
            "id_dist_equal": id_dist_ok,
            "save_load_roundtrip_equal": reload_ok,
            "n_shard_files": len([f for f in files if f.endswith(".npy")]),
            "build_s": round(build_s, 2),
            "search_s": round(search_s, 2),
            "total_s": round(time.time() - t_all, 2),
            "platform": "cpu (2 processes x 4 virtual devices)",
        }
        with open(out, "w") as f:
            f.write(json.dumps(payload) + "\n")
        print(json.dumps(payload), flush=True)
    jax.distributed.shutdown()


def launcher(out: str, nprocs: int):
    save_dir = tempfile.mkdtemp(prefix="vt_multiproc_")
    procs = []
    for i in range(nprocs):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=4"
                            + " --xla_cpu_max_isa=AVX2").strip()
        env["JAX_PLATFORMS"] = "cpu"
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = ":".join(
            [repo] + [p for p in env.get("PYTHONPATH", "").split(":")
                      if p and p != repo])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--proc", str(i),
             "--nprocs", str(nprocs), "--save-dir", save_dir, "--out", out],
            env=env))
    rcs = [p.wait(timeout=1200) for p in procs]
    if any(rcs):
        print(f"worker exit codes: {rcs}", file=sys.stderr)
        sys.exit(1)
    with open(out) as f:
        print(f.read().strip())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--proc", type=int, default=-1)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--save-dir", default="")
    ap.add_argument("--out", default="multiproc.json")
    args = ap.parse_args()
    if args.proc < 0:
        launcher(args.out, args.nprocs)
    else:
        worker(args.proc, args.nprocs, args.save_dir, args.out)


if __name__ == "__main__":
    main()
