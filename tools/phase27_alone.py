#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 27 alone on one card (~1 min).

    python3 tools/phase27_alone.py [--out phase27.json]

Starts two gloo ranks on ``cuda:0`` (phase 17 (c)'s group, without its
sweeps), each calling ``chip_smoke.across_child``; the main process
computes ``across_serial`` meanwhile, then holds the ranks to it with
``across_check`` and runs ``across_remat``.  ``--out`` writes the
record as JSON; it raises where the whole script would.
"""
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as CS  # noqa: E402


def child(init: str, rank: int, out: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    dev = torch.device(CS.DIST_DEVICE)
    M.dist_init(init, num_processes=2, process_id=rank, backend="gloo",
                device=dev, init_timeout_s=CS.DIST_COLLECTIVE_TIMEOUT_S)
    Path(out).write_text(json.dumps(CS.across_child(torch, dev, rank)))
    dist.destroy_process_group()


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        return 0
    out = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv \
        else None
    import torch
    if not torch.cuda.is_available():
        print("phase27_alone: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = CS.nvidia_smi_line()
    CS.log(f"device: {smi} (torch {torch.__version__})")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    cmds = [[sys.executable, __file__, "--child", f"file://{tmp / 'init'}",
             str(r), str(tmp / f"rank{r}.json")] for r in range(2)]
    wall = CS.run_group("phase 27", cmds, tmp, CS.DIST_TIMEOUT_S,
                        meanwhile=lambda: CS.across_serial(
                            torch, tmp / "serial.json"))
    rec = CS.across_check(
        [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)],
        json.loads((tmp / "serial.json").read_text()), smi)
    t = time.perf_counter()
    rec["d"] = CS.across_remat(torch, smi)
    rec["group_wall_s"], rec["d_s"] = wall, time.perf_counter() - t
    if out:
        Path(out).write_text(json.dumps(rec, indent=1))
    CS.log(f"phase 27 alone: group {wall:.2f} s, (d) {rec['d_s']:.2f} s", smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
