"""The control (the reference with its hash cut to 32 bits, in the port's
place) comes out not correct: on a tiny cell here, and at a cell's own size
on the card."""
import pytest

import control
from njbench import check


def test_control_fails_tiny(tiny):
    cfg, tr = tiny
    for seed in (1, 2**31 + 5, 2**33 + 1):
        got = control.control(cfg, tr, seed, "cpu")
        assert any(got[k] > lim for k, lim in check.LIMITS.items()), got


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["celegans_2ref.sr_draft", "human_chr1_2ref.lr_draft"])
def test_control_fails_at_cell_size(cuda, cell, capsys):
    assert control.main(["--workload", cell, "--seeds", "11,12,13", "--device", cuda]) == 0
    import json

    least = json.loads(capsys.readouterr().out.splitlines()[-1])["least"]
    assert any(least[k] > lim for k, lim in check.LIMITS.items())
