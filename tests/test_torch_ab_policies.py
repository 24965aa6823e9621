"""The port's A/B policy harness (``python -m
direct_stereo_slam_tpu_torch.ab_policies``) on the CPU at 96x48 and 2
frames: for each of its three A/Bs both arms run on a scenario the switch
matters in (the winner policy and the BA's forced acceptance on nominal
forward motion, the reference loop acceptance on the fast-rotation lap
with loop closure), and each arm's configuration differs from the
baseline's in exactly the switch it names. The CLI writes its table to
``--out`` and nothing else (no PARITY.md)."""

import os

import numpy as np
import pytest

from direct_stereo_slam_tpu_torch import ab_policies as ab
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SIZE = dict(width=96, height=48, device="cpu")
FRAMES = 2
# each A/B on the scenario whose behaviour its switch changes
ARMS = {"serial_winner": "nominal", "force_accept": "nominal",
        "reference_loop": "fast_rotation"}


@pytest.fixture(scope="module")
def baselines():
    return {s: ab.run_one(s, "baseline", FRAMES, **SIZE) for s in set(ARMS.values())}


@pytest.mark.parametrize("variant", list(ARMS))
def test_both_arms_run_and_differ_in_their_switch(baselines, variant):
    scenario = ARMS[variant]
    base, arm = baselines[scenario], ab.run_one(scenario, variant, FRAMES, **SIZE)
    for r in (base, arm):
        assert r["scenario"] == scenario and 1 <= r["frames"] <= FRAMES
        assert np.isfinite(r["ate"]) and np.isfinite(r["endpoint"])
        assert ("loops" in r) == (scenario == "fast_rotation")
    differ = {k for k in base["switches"] if base["switches"][k] != arm["switches"][k]}
    assert differ == {variant}
    assert arm["switches"][variant] == ab.SWITCHES[variant][2]
    assert arm["variant"] == variant and base["variant"] == "baseline"


def test_cli_writes_only_its_table(tmp_path, monkeypatch, baselines):
    monkeypatch.setattr(ab, "GRID", (("nominal", ("baseline",)),))
    # the run itself is the one the fixture made
    monkeypatch.setattr(ab, "run_one", lambda s, v, *a, **kw: dict(baselines[s], variant=v))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "ab.md"
    assert ab.main(["--device", "cpu", "--frames", "2", "--width", "96", "--height", "48",
                    "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0].startswith("| scenario | variant |") and len(lines) == 3
    assert lines[2].startswith("| nominal | baseline | ")
    assert sorted(os.listdir(tmp_path)) == ["ab.md"]


def test_cli_without_a_card_stops(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        ab.main(["--frames", "2"])
    assert "--device cpu" in str(e.value) or "device='cpu'" in str(e.value)
