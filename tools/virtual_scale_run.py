"""Largest-feasible compact-sharded build + search on the 8-device
VIRTUAL CPU mesh, on the CPU by design: the distributed pipeline's scale
behaviour without a card.

Runs the production distributed pipeline end to end at N far beyond the
reference's 120M single-run cap per rank-count (src/build_hash_tables.cc:66):
device-born corpus -> build_sharded_compact on a (4, 2, 1) mesh ->
sharded_compact_search -> distance-multiset oracle vs the independent
sharded linear scan -> save/load round-trip -> search-after-load check.
Writes one JSON artifact.

Run (CPU, any rig): python tools/virtual_scale_run.py [N] [out.json]
"""
import json
import os
import resource
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import numpy as np


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from verticut_tpu import codes
    from verticut_tpu.config import MIHConfig, SearchConfig
    from verticut_tpu.parallel import make_mesh
    from verticut_tpu.search.sharded import sharded_linear_search
    from verticut_tpu.search.sharded_compact import (
        build_sharded_compact, load_sharded_compact, save_sharded_compact,
        sharded_compact_search)

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64_000_000
    out_path = sys.argv[2] if len(sys.argv) > 2 else "virtual_scale.json"
    nq, k = 512, 10
    n_oracle = 32
    cfg = MIHConfig(bits=128, n_tables=4)
    mesh = make_mesh(4, 2, 1)
    assert len(jax.devices()) == 8, jax.devices()
    out = {"metric": "virtual_scale_run", "n": n, "backend": "cpu-virtual",
           "mesh": {"table": 4, "shard": 2, "query": 1}, "k": k, "nq": nq}

    t0 = time.time()
    packed = codes.clustered_codes_device(0, n, cfg.bits,
                                          n_clusters=max(2, n // 200),
                                          flip_p=0.02)
    packed.block_until_ready()
    out["gen_s"] = round(time.time() - t0, 1)

    t0 = time.time()
    index = build_sharded_compact(packed, cfg, mesh, slack=1.5)
    jax.block_until_ready(index.idrows)
    out["build_s"] = round(time.time() - t0, 1)
    out["memory_stats"] = index.memory_stats()
    print(f"build: {out['build_s']}s stats={out['memory_stats']}",
          flush=True)

    rng = np.random.default_rng(3)
    sel = jnp.asarray(rng.integers(0, n, nq))
    queries = jax.device_get(packed[sel])  # host copy, re-fed sharded

    t0 = time.time()
    res = sharded_compact_search(index, queries, SearchConfig(knn=k))
    out["search_s"] = round(time.time() - t0, 1)
    out["mean_radius"] = float(np.mean(res.radius))
    print(f"search: {out['search_s']}s mean_radius={out['mean_radius']}",
          flush=True)

    # oracle: independent sharded linear scan over the id-sharded codes
    t0 = time.time()
    ld, _li = sharded_linear_search(mesh, index.codes, queries[:n_oracle],
                                    k, n_total=n)
    ld = np.sort(np.asarray(ld), -1)
    ed = np.sort(res.dists[:n_oracle], -1)
    out["oracle_q"] = n_oracle
    out["oracle_s"] = round(time.time() - t0, 1)
    out["oracle_multiset_equal"] = bool(np.array_equal(ld, ed))
    print(f"oracle: equal={out['oracle_multiset_equal']}", flush=True)

    # persistence round-trip at scale (VERDICT r3 #4: the op-log role)
    save_dir = os.environ.get("VERTICUT_SCALE_SAVE", "/tmp/vt_scale_idx")
    t0 = time.time()
    save_sharded_compact(save_dir, index)
    out["save_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    index2 = load_sharded_compact(save_dir, mesh)
    res2 = sharded_compact_search(index2, queries[:n_oracle],
                                  SearchConfig(knn=k))
    out["load_search_s"] = round(time.time() - t0, 1)
    out["load_multiset_equal"] = bool(np.array_equal(
        np.sort(res2.dists, -1), ed))
    out["save_bytes"] = sum(
        os.path.getsize(os.path.join(save_dir, f))
        for f in os.listdir(save_dir))
    print(f"save/load: equal={out['load_multiset_equal']}", flush=True)

    out["peak_rss_gb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20), 2)
    out["ok"] = (out["oracle_multiset_equal"]
                 and out["load_multiset_equal"])
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", out_path, "ok:", out["ok"])


if __name__ == "__main__":
    main()
