"""The frozen yardstick on hand-worked cases, and its copies of the
program's rules against the program as it stands."""
import pytest

from qmcbench import work

Q = {"rho": 0.3, "bits_in": 3, "bits_out": 5, "subtile": [8, 128]}


def test_qmc_bytes_is_the_format_not_the_container():
    # 10 x 10 subtiles, 30 of them outliers: exactly 3.6 bits a weight,
    # two fp32 scales per column, one tag bit per subtile
    k, n = 80, 1280
    assert work.qmc_bytes(k, n, Q) == k * n * 3.6 / 8 + 2 * n * 4 + 100 / 8
    # [2048, 5632]: 11264 subtiles, round(3379.2) = 3379 outliers
    got = work.qmc_bytes(2048, 5632, Q)
    assert got == (7885 * 3 + 3379 * 5) * 1024 / 8 + 2 * 5632 * 4 + 1408
    assert got < 2048 * 5632          # under the port's byte per code


@pytest.mark.parametrize("q0,n,window", [(0, 5, None), (3, 4, 2), (0, 5, 3),
                                         (1020, 8, 1024), (2000, 1, 1024),
                                         (7, 40, 16), (0, 1, None)])
def test_keys_counted_per_query(q0, n, window):
    want = sum(min(p + 1, window) if window else p + 1
               for p in range(q0, q0 + n))
    assert work._keys(q0, n, window) == want


def test_window_floor_on_pages():
    m = {"head_dim": 64, "n_heads": 25, "n_kv_heads": 5}
    page_bytes = 2 * 16 * 5 * 64 * 4            # K and V of one page
    act = 2 * 25 * 64 * 4                       # q read, output written
    # a decode query at position 2000: global reads pages 0..125; a
    # 1024 window starts at position 977, page 61
    f, b = work.attention_call([work.Lane(2000, 1)], m, None, 16)
    assert b == 126 * page_bytes + act and f == 4 * 64 * 25 * 2001
    f, b = work.attention_call([work.Lane(2000, 1)], m, 1024, 16)
    assert b == 65 * page_bytes + act and f == 4 * 64 * 25 * 1024
    # a chunk reads from its first query's floor
    _, b = work.attention_call([work.Lane(1500, 100)], m, 1024, 16)
    assert b == (1599 // 16 - 477 // 16 + 1) * page_bytes + 100 * act


def test_least_time_takes_the_larger_term():
    assert work.least_s(989e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_routes_and_widths_match_the_program():
    from repro_torch.kernels.ops import qmm_plan
    from repro_torch.serve.steps import width_ladder
    for chunk in (4, 16, 100, 512, 1024):
        assert work.width_ladder(chunk) == tuple(width_ladder(chunk))
    for m in (1, 4, 8, 9, 64, 120, 128, 130, 512, 2048, 4096):
        for k, n in ((2048, 5632), (1600, 5504), (5632, 2048)):
            plan = qmm_plan(m, k, n, (8, 128))
            assert work.qmm_route(m, k, n) == (plan["path"], plan["pad_m"])
    assert work.step_width(1, 512) == 1
    assert work.step_width(300, 512) == 512
    assert work.step_width(5, 512) == 8


def test_step_need_counts_each_weight_once():
    m = {"d_model": 64, "vocab": 256, "n_layers": 2, "pattern": ["attn"],
         "head_dim": 16, "n_heads": 4, "n_kv_heads": 4}
    projs = [work.Proj(64, 256, 1, True, head=True),
             work.Proj(64, 64, 2, False)]
    lanes = [work.Lane(10, 1), work.Lane(3, 1)]
    f1, b1 = work.step_need(m, Q, projs, lanes, 2, 16)
    f2, b2 = work.step_need(m, Q, projs, lanes + [work.Lane(5, 1)], 3, 16)
    # one more lane adds its products, not another copy of the weights
    w = work.qmc_bytes(64, 256, Q) + 64 * 64 * 2 * 4
    assert b1 > w and b2 - b1 < w
    assert f2 - f1 == pytest.approx(2 * (64 * 256 + 2 * 64 * 64)
                                    + 2 * 4 * 16 * 4 * 6)
