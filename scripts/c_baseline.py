"""Reproduce the compiled-C scoring baseline that bench.py compares against.

Builds the SAME random 1000-tree / depth-4 oblivious model bench.py times on
the chip (identical seed and shapes), emits the reference-style table +
bit-OR C source through io/codegen.generate_oblivious (the
generate_oblivious.cc:137-330 output format), compiles it with the
reference's release flags (-O3 -march=native), and times the serial per-doc
scoring loop the way quickscore does (src/quickscore.cc:96-121: rounds over
the dataset, average per-doc time).

Prints one JSON line: {"metric": "c_baseline_scoring_throughput_1000tree",
"value": <docs/s>, ...}.  The resulting docs/s is the provenance of
bench.py's BASELINE_DOCS_PER_SEC (re-run this script on the measurement host
to regenerate it).

Usage: python scripts/c_baseline.py [--docs 20000] [--rounds 10]
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TIMING_MAIN = r"""
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

int main(int argc, char **argv) {
    int n = argc > 1 ? atoi(argv[1]) : 20000;
    int rounds = argc > 2 ? atoi(argv[2]) : 10;
    int f = argc > 3 ? atoi(argv[3]) : 136;
    float *v = malloc((size_t)n * f * sizeof(float));
    srand(42);
    for (long i = 0; i < (long)n * f; ++i)
        v[i] = (float)rand() / RAND_MAX * 4.0f - 2.0f;
    /* warm-up sweep */
    double acc = 0.0;
    for (int i = 0; i < n; ++i) acc += ranker(v + (long)i * f);
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int r = 0; r < rounds; ++r)
        for (int i = 0; i < n; ++i) acc += ranker(v + (long)i * f);
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double dt = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
    /* print acc so the loop cannot be dead-code-eliminated */
    fprintf(stderr, "# acc=%g\n", acc);
    printf("%.17g\n", (double)n * rounds / dt);
    free(v);
    return 0;
}
"""


class _ShimModel:
    """Just enough surface for generate_oblivious()."""

    def __init__(self, obl):
        self._obl = obl

    def oblivious_ensemble(self):
        return self._obl


def build_model():
    """A model of the shape bench.py scores on the device (1000 depth-4
    oblivious trees over 136 features) — built from plain numpy arrays so
    this pure-host measurement never touches a jax backend (it runs inside
    bench.py before the device sections)."""
    from quickrank_tpu.trees.oblivious import ObliviousEnsemble

    N, F, T, DEPTH = 1 << 17, 136, 1000, 4
    L = 2**DEPTH
    rng = np.random.default_rng(0)
    rng.normal(size=(N, F))  # consume the doc draw to stay stream-identical
    return ObliviousEnsemble(
        fid=rng.integers(0, F, size=(T, DEPTH)).astype(np.int32),
        thr=rng.normal(size=(T, DEPTH)).astype(np.float32),
        thr_bin=np.zeros((T, DEPTH), np.int32),
        leaf=rng.normal(size=(T, L)).astype(np.float32),
        weight=np.full((T,), 0.1, np.float32),
        num_trees=np.int32(T),
    )


def measure(docs: int = 20000, rounds: int = 10) -> float:
    """Codegen -> gcc -O3 -march=native -> timed serial loop; returns
    docs/sec.  Importable (bench.py measures the live same-host baseline
    instead of trusting a recorded constant — VM hosts vary round to
    round).  Raises on any toolchain failure; callers fall back."""
    from quickrank_tpu.io.codegen import generate_oblivious

    code = generate_oblivious(_ShimModel(build_model()))
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "ranker.c")
        exe = os.path.join(d, "ranker")
        with open(src, "w") as f:
            f.write(code + TIMING_MAIN)
        t0 = time.time()
        subprocess.run(
            ["gcc", "-O3", "-march=native", "-o", exe, src, "-lm"],
            check=True,
        )
        print(f"# compiled in {time.time() - t0:.1f}s", file=sys.stderr)
        out = subprocess.run(
            [exe, str(docs), str(rounds), "136"],
            capture_output=True, text=True, check=True,
        )
    return float(out.stdout.strip())


class _DeepShim:
    """Just enough surface for generate_condop()."""

    def __init__(self, ens):
        self._ens = ens

    def _require_model(self):
        return self._ens


def measure_deep(docs: int = 20000, rounds: int = 10) -> float:
    """Same-host C baseline for the DEEP (any-depth) scoring workload:
    the exact random best-first-shaped 1000 x 16-leaf model
    bench.py::bench_deep_scoring times on-chip, emitted through the
    reference's conditional-operators generator
    (generate_conditional_operators.cc:93-112 output format) and timed
    with the same serial quickscore loop.  NOTE: touches jax (the model
    builder) — call only after the device sections, unlike measure()."""
    from quickrank_tpu.io.codegen import generate_condop
    from quickrank_tpu.trees.random_ensemble import random_bestfirst_ensemble

    ens = random_bestfirst_ensemble(1000, 16, 136, seed=5)
    code = generate_condop(_DeepShim(ens))
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "ranker.c")
        exe = os.path.join(d, "ranker")
        with open(src, "w") as f:
            f.write(code + TIMING_MAIN)
        t0 = time.time()
        subprocess.run(
            ["gcc", "-O3", "-march=native", "-o", exe, src, "-lm"],
            check=True, timeout=600,
        )
        print(f"# deep condop compiled in {time.time() - t0:.1f}s",
              file=sys.stderr)
        out = subprocess.run(
            [exe, str(docs), str(rounds), "136"],
            capture_output=True, text=True, check=True, timeout=900,
        )
    return float(out.stdout.strip())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=20000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--deep", action="store_true",
                    help="measure the deep condop model instead")
    args = ap.parse_args(argv)

    if args.deep:
        docs_per_sec = measure_deep(args.docs, args.rounds)
    else:
        docs_per_sec = measure(args.docs, args.rounds)
    print(
        f"# {args.docs} docs x {args.rounds} rounds x 1000 trees: "
        f"{docs_per_sec:,.0f} docs/s single-thread",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "c_baseline_scoring_throughput_1000tree",
                "value": docs_per_sec,
                "unit": "docs/sec (single thread, -O3 -march=native)",
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
