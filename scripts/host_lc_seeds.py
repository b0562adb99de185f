#!/usr/bin/env python3
"""`chip_smoke.py`'s path 10 ("host_lc") once for each of several seeds
of the loop closer's generator: how many loops the port's host-policy
closer closes over its RANSAC streams (the reference's counterpart:
`scripts/reference_loop_closer.py 280 SEED`). Prints one JSON line a
seed (gates held or the failed ones, loops, the frames they closed at,
solves run and succeeded, ATE) and one with all of them; each seed's
result line goes to OUT/SEED/host_lc.json.

Run on a machine with one GPU, from the repository root:
    python3 scripts/host_lc_seeds.py 101,102,103,104,105 [OUT]
(OUT chip_smoke_out/seeds by default; about two minutes a seed on an
H100).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from openmavis_tpu_torch.frontend import matcher_cuda as mc  # noqa: E402
from openmavis_tpu_torch.pipeline import loop_closing  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("host_lc_seeds.py needs a CUDA device")
    mc.build()
    card = cs.gpu_line()
    print(card)
    dev = torch.device("cuda", 0)
    init = loop_closing.LoopCloser.__init__
    out_dir = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        "chip_smoke_out", "seeds")
    out = []
    try:
        for seed in [int(x) for x in sys.argv[1].split(",")]:
            def seeded(self, *a, seed=seed, **kw):
                init(self, *a, **dict(kw, seed=seed))

            loop_closing.LoopCloser.__init__ = seeded
            cs.OUT_DIR = os.path.join(out_dir, str(seed))
            t0 = time.time()
            try:
                cs.phase_host_lc(torch, dev, mc, card)
                gates = True
            except AssertionError as e:
                gates = str(e)
            with open(os.path.join(cs.OUT_DIR, "host_lc.json")) as f:
                d = json.load(f)
            solves = [e for e in d["lc_trace"] if e["stage"] == "solve"]
            out.append(dict(seed=seed, gates=gates,
                            loops=d["loop_closures"],
                            closed_at=d["closed_at_frames"],
                            solves=len(solves),
                            solves_ok=sum(e["ok"] for e in solves),
                            ate=d["ate_rmse_m"], s=time.time() - t0))
            print(json.dumps(out[-1]), flush=True)
    finally:
        loop_closing.LoopCloser.__init__ = init
    print(json.dumps({"card": card, "seeds": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
