"""The counting functions against numbers worked out by hand."""

from benchmark.counts import flops as F


def test_mlp_flops():
    # the radiance field's sigma MLP: 32 -> 64 -> 16, 1000 rows: 2 x 1000 x (2048 + 1024)
    assert F.mlp_flops(1000, [(32, 64), (64, 16)]) == 6_144_000


def test_hashgrid_flops():
    # 16 levels x 8 corners x 2 features x 2 = 512 a row; one corner: 64
    assert F.hashgrid_flops(10, 16, 2, stochastic=False) == 5120
    assert F.hashgrid_flops(10, 16, 2, stochastic=True) == 640


def test_step_factor():
    assert F.step_factor(True) == 3 and F.step_factor(False) == 1


def test_k4_bytes():
    # 1000 updates of 2 channels: 1000 x (8 + 4) read, 1000 rows x 8 written
    assert F.k4_bytes(1000, 2, 6_000_000) == 20_000
    # more updates than rows: every row written once
    assert F.k4_bytes(1000, 2, 10) == 12_000 + 80


def test_nominal_rays():
    # bench.py: 256^2 x (1 + 32 x 16) = 33,619,968
    assert F.nominal_rays(256, 256, 32, 5, 2) == 33_619_968
    assert F.nominal_rays(800, 800, 32, 5, 2) == 328_320_000


def test_roofline_share():
    # 3.35 GB at 3.35 TB/s is 1 ms; taking 2 ms is 50%
    assert abs(F.roofline_share(3.35e9, 0.0, 2e-3, 3.35e12, 989e12) - 50.0) < 1e-9
    # bound by the operations when they take longer than the bytes
    assert abs(F.roofline_share(0.0, 989e9, 4e-3, 3.35e12, 989e12) - 25.0) < 1e-9
