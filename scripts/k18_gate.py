"""K18's HM / bM gate (``tests/test_torch_cuda_window_state.py``) measured
on the card: on each of the card tests' marginalization cases and on
every keyframe tail of ``chip_smoke.py``'s e2e sequence, the points stage
alone (K18 and ``marginalize_plain`` with no frame: the largest error over
the largest entry of the change the stage made), each whole result's
distance from float64 frame marginalizations of its own points stage
(the kernel's and the plain version's, over the largest entry), and the
points stage of a K18 that leaves out the last flagged point with a
live pair. One JSON line a case or tail; then the window phase of
``chip_smoke.py`` (K16-K18 against their plain versions, timed, with
their bounds) on the same sequence. Needs a CUDA card; run from the
repository's root:

    python scripts/k18_gate.py
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402
import test_torch_cuda_window_state as T  # noqa: E402
from direct_stereo_slam_tpu_torch.models import ba  # noqa: E402
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode  # noqa: E402


def report(tag, st, lin, marg, drop, slots, cfg):
    got = ba.marginalize(st, lin, marg, drop, slots, cfg)
    want = ba.marginalize_plain(st, lin, marg, drop, slots, cfg)
    points, frames = T._k18_errors(st, lin, marg, drop, slots, cfg, got, want)
    out = dict(tag=tag, slots=list(slots), n=int(np.asarray(marg).sum()), points=points,
               frames={k: dict(k_rel=v[0] / max(v[2], 1e-30), p_rel=v[1] / max(v[2], 1e-30),
                               ok=T._frames_ok(*v)) for k, v in frames.items()})
    if np.asarray(marg).any():
        short = np.array(marg, bool)
        short[T._last_live(st, short)] = False
        gp = ba.marginalize(st, lin, short, drop, [], cfg)
        wp = ba.marginalize_plain(st, lin, marg, drop, [], cfg)
        out["fault"] = {n: T._change_err(getattr(gp, n), getattr(wp, n), getattr(st, n))
                        for n in ("HM", "bM")}
    print("k18 " + json.dumps(out), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.card_info(), flush=True)
    for W, slots, points in T.MARG_CASES:
        st, cfg, marg, drop, lin = T._marg_window(dev, W, points)
        report(f"case W={W}", st, lin, marg, drop, slots, cfg)
    t0 = time.time()
    ds, frames, cfg, intr = cs.sequence_setup(dev, cs.E2E_FRAMES, speed=0.4)
    cs.run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev)
    with cs.BaTraffic() as bt, cs.MargTraffic() as mt:
        cs.run_sequence(torch, SLAMNode, cfg, intr, ds, frames, dev)
    print(f"e2e twice {time.time() - t0:.1f} s; {len(bt.calls)} BA calls, "
          f"{len(mt.calls)} tails", flush=True)
    for i, (st_m, lin_m, marg, drop, slots, cfg_m) in enumerate(mt.calls):
        report(f"tail {i}", st_m, lin_m, marg, drop, slots, cfg_m)
    print("rows " + json.dumps(cs.window_phase(torch, dev, bt.calls, mt.calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
