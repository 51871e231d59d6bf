#!/usr/bin/env python3
"""Time zfp's ``EbGridModel.train`` in two source trees on one GPU, in
turns, as ``chip_smoke.py`` trains it.

    git archive <rev> | tar -x -C build/ab_base     # the tree to compare
    python3 tools/ab_train.py --base build/ab_base

Each turn is a fresh process of its tree (base, this, this, base): it
makes the 32 cesm-cloud 1800 x 1800 training slices on the card from
seed 0 and the 6-point eb grid of ``chip_smoke.py``, trains once to warm
up (the kernels' build, the first launches), then times a second
training by the host clock with the card synchronized.  Host time
spreads between calls more than device time, so only turns of one call
are compared.  Prints one JSON object, last, with the ``nvidia-smi``
name and power limit of the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import nvidia_smi_line  # noqa: E402

COMPRESSOR = "zfp"     # no lossless stage: its time is the size model's

TURN = """
import sys, time
sys.path.insert(0, {src!r})
import numpy as np, torch
from repro_torch.core import predictors as P, usecases as UC
from repro_torch.data import scientific as TS
spec = TS.FIELDS["cesm-cloud"]
train = TS.field_slices("cesm-cloud", count=40, n=spec.full_n, seed=0,
                        device="cuda")[:32]
ebs = spec.eps * 10.0 ** np.linspace(-0.5, 2.0, 6)
cfg = P.PredictorConfig(use_kernels=True)
UC.EbGridModel.train(train, {name!r}, ebs, cfg=cfg)
torch.cuda.synchronize()
t = time.perf_counter()
UC.EbGridModel.train(train, {name!r}, ebs, cfg=cfg)
torch.cuda.synchronize()
print(time.perf_counter() - t)
"""


def turn(tree: Path, name: str) -> float:
    out = subprocess.run(
        [sys.executable, "-c", TURN.format(src=str(tree / "src"), name=name)],
        check=True, capture_output=True, text=True, timeout=900).stdout
    return float(out.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="root of the tree to compare against")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ab_train: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    trees = {"base": args.base.resolve(), "this": ROOT}
    times = {"base": [], "this": []}
    for tag in ("base", "this", "this", "base"):
        times[tag].append(turn(trees[tag], COMPRESSOR))
        print(f"train {COMPRESSOR} ({tag}): {times[tag][-1]:.3f} s "
              f"[{smi}]", flush=True)
    print(json.dumps({"device": smi, "base": str(args.base),
                      "compressor": COMPRESSOR, "train_s": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
