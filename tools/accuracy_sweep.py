#!/usr/bin/env python
"""Run the full reference accuracy protocol (clustered + uniform corpora,
k sweep per ``src/test_approximate_accuracy.py:12``) and wrap the rows
into one artifact JSON. Each sweep runs in a child process, one after the
other, so only one JAX process holds the card at a time.

Usage: python tools/accuracy_sweep.py [out.json] [N] [count]
"""

import json
import subprocess
import sys

REPO = __file__.rsplit("/", 2)[0]
sys.path.insert(0, REPO)


def sweep(uniform: bool, n: int, count: int):
    cmd = [sys.executable, f"{REPO}/tools/accuracy_test.py",
           "--synth", str(n), "-c", str(count)]
    if uniform:
        cmd.append("--uniform")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=2400)
    if out.returncode != 0:
        print(out.stderr[-2000:], file=sys.stderr)
        raise SystemExit(f"sweep uniform={uniform} failed rc={out.returncode}")
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    for r in rows:
        print(f"uniform={uniform} k={r['k']} exact={r['exact_s']}s "
              f"approx={r['approx_s']}s acc={r['accuracy']}",
              file=sys.stderr, flush=True)
    return rows


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "accuracy.json"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
    count = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    from verticut_tpu.utils.device import card_line
    art = {
        "card": card_line(),
        "protocol": "src/accuracy_test.cc:72-135 metrics over "
                    "src/test_approximate_accuracy.py:12 k-sweep",
        "corpus_n": n,
        "queries_per_k": count,
        "bits": 128,
        "n_tables": 4,
        "note": "queries drawn from the corpus; approx = k*20 pool "
                "early-stop (search_worker.h:14) with the "
                "approx_exact_crossover: pools wider than 1024 run the "
                "exact engine; times are warm batched seconds for all "
                "queries on the card named above; accuracy = fraction "
                "of approx results within the exact max distance",
        "clustered": sweep(False, n, count),
        "uniform": sweep(True, n, count),
    }
    with open(out_path, "w") as f:
        json.dump(art, f, indent=1)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
