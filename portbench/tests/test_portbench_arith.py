"""The yardstick's arithmetic: FLOPs per position from a configuration's
shapes against a count by hand, and the kernels' bytes against the
numbers chip_smoke.py printed for them."""

import pytest

from portbench import roofline as RF
from portbench.reference import net as NET

from _tiny import CFG


def test_flops_per_position_by_hand():
    c, m, gp, area = 16, 8, 4, 81
    trunk = area * (9 * 22 * c) + 19 * c
    block = area * (c * m + m * c)                  # 1x1 down and up
    plain_res = area * 2 * 9 * m * m                # two 3x3 mid -> mid
    gpool_res = area * (9 * m * (m - gp) + 9 * m * gp + 9 * (m - gp) * m) \
        + 3 * gp * (m - gp)
    blocks = 2 * block + 2 * plain_res + plain_res + gpool_res
    p1, g1, v1, v2, sbv2, k, npol = 6, 6, 6, 8, 8, 2, 6
    buckets = 2 * (area + 60)
    policy = area * (c * p1 + c * g1 + p1 * npol) + 3 * g1 * p1 * 2 \
        + p1 * npol
    value = area * (c * v1 + v1 + v1 + 2 * c + 4 * c) \
        + 3 * v1 * v2 + v2 * (3 + 10 + 8) + 3 * v1 * sbv2 \
        + buckets * (sbv2 + sbv2 + sbv2 * k) + 3 * v1 * k
    want = 2.0 * (trunk + blocks + policy + value)
    assert RF.flops_per_position(CFG) == want


@pytest.mark.parametrize("name,gflop", [("b18c384nbt", 18.876604288),
                                        ("b28c512nbt", 52.316868512)])
def test_flops_of_the_cells(name, gflop):
    import json
    from _tiny import ROOT
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    assert RF.flops_per_position(cfg) == pytest.approx(gflop * 1e9, rel=1e-9)
    # the bulk: blocks x area x (two 1x1 convs + four 3x3 convs)
    blocks = sum(n for _, n in cfg["blocks"])
    c, m = cfg["trunk"], cfg["mid"]
    rough = 2 * blocks * 361 * (2 * c * m + 4 * 9 * m * m)
    assert 0.95 < RF.flops_per_position(cfg) / rough < 1.0


def test_kernel_bytes_as_chip_smoke_printed():
    # K2 at the main path's [128, 361]: chip_smoke.py's bound 0.00011 ms
    assert RF.k2_bytes(128, 19) == 2 * 128 * 361 * 4
    assert RF.bound_s(RF.k2_bytes(128, 19), RF.k2_ops(128, 19)) * 1e3 == \
        pytest.approx(0.00011, abs=5e-6)
    # K1 at 4096 lanes with about 3000 active: its bound 0.00132 ms
    assert RF.k1_bytes(3030, 4096, 19) == 3030 * 364 * 4 + 2 * 4096
    assert RF.bound_s(RF.k1_bytes(3030, 4096, 19)) * 1e3 == \
        pytest.approx(0.00132, abs=5e-6)


def test_param_shapes_match_the_program():
    from katago_torch.models import model as M
    from _tiny import register_preset
    model = M.KataGoModel(register_preset(), 9)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert NET.param_shapes(CFG) == want
