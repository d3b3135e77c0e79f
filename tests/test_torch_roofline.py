"""The port's roofline module against the reference's, on the CPU.

* ``model_flops``, ``cache_bytes_global`` and ``ideal_bytes`` equal the
  reference's for every (arch x shape) of ``SHAPES``, within a relative
  1e-12.
* ``tests/test_dryrun_roofline.py``'s ``test_roofline_cell_terms`` and
  ``test_model_flops_and_ideal_bytes``, restated at the H100's constants.
* A ``RooflineCell`` with every term known prints and serialises as the
  reference's does with the same constants; a term nobody measured is
  ``None`` in every property that needs it and ``-`` in the table.
* The three HLO parsers raise ``NotImplementedError``; the collective
  bytes come from a ``CoreEngine``'s ledger instead, in the reference's
  kind names.
"""
import pytest

import repro.configs as jconf
from repro.launch import roofline as jrl
from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape
from repro_torch.core.engine import CoreEngine
from repro_torch.core.nqe import CommOp
from repro_torch.launch import roofline as rl

from _torch_threads import one_thread  # noqa: F401

H100 = {"PEAK_FLOPS": 989e12, "HBM_BW": 3.35e12, "ICI_BW": 450e9,
        "HBM_BYTES": 80e9}


def test_constants_are_the_h100s():
    for name, v in H100.items():
        assert getattr(rl, name) == v, name
    assert rl.PEAK_FLOPS_BY_DTYPE == {"bfloat16": 989e12, "float32": 67e12,
                                      "float64": 34e12}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_formulas_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jconf.get_config(arch)
    for name in SHAPES:
        shape, jshape = get_shape(name), jconf.get_shape(name)
        for fn in ("model_flops", "cache_bytes_global", "ideal_bytes"):
            got, want = getattr(rl, fn)(cfg, shape), \
                getattr(jrl, fn)(jcfg, jshape)
            assert got == pytest.approx(want, rel=1e-12, abs=0), (fn, name)


def test_roofline_cell_terms():
    cell = rl.RooflineCell(
        arch="x", shape="train_4k", mesh="16x16", chips=256,
        flops_per_chip=rl.PEAK_FLOPS, hbm_bytes_per_chip=rl.HBM_BW,
        coll_bytes_per_chip=rl.ICI_BW, coll_by_kind={},
        model_flops_global=rl.PEAK_FLOPS * 256,
        memory_per_chip_gb=10.0, compile_seconds=1.0,
        ideal_bytes_global=rl.HBM_BW * 256)
    assert cell.t_compute == pytest.approx(1.0)
    assert cell.t_memory == pytest.approx(1.0)
    assert cell.t_collective == pytest.approx(1.0)
    assert cell.roofline_fraction == pytest.approx(1.0)
    assert cell.useful_ratio == pytest.approx(1.0)
    assert cell.t_ideal == pytest.approx(1.0)


def test_model_flops_and_ideal_bytes():
    cfg = get_config("llama3.2-3b")
    tr = get_shape("train_4k")
    de = get_shape("decode_32k")
    n = cfg.num_active_params()
    assert rl.model_flops(cfg, tr) == pytest.approx(6 * n * 256 * 4096)
    assert rl.model_flops(cfg, de) == pytest.approx(2 * n * 128)
    assert rl.cache_bytes_global(cfg, de) == pytest.approx(
        2 * 128 * 32768 * 8 * 128 * 2 * 28)
    assert rl.ideal_bytes(cfg, de) > rl.cache_bytes_global(cfg, de)


def _cells(mod, **kw):
    base = dict(arch="llama3.2-3b", shape="train_4k", mesh="16x16",
                chips=256, flops_per_chip=3e14, hbm_bytes_per_chip=2e11,
                coll_bytes_per_chip=4e9, coll_by_kind={"all-reduce": 4e9},
                model_flops_global=5e16, memory_per_chip_gb=12.5,
                compile_seconds=0.5, ideal_bytes_global=1e13)
    base.update(kw)
    return mod.RooflineCell(**base)


@pytest.mark.parametrize("terms", [
    {}, {"flops_per_chip": 1e12, "hbm_bytes_per_chip": 9e12},
    {"coll_bytes_per_chip": 4e12}])
def test_full_cells_print_and_serialise_as_the_reference(monkeypatch, terms):
    """With every term known and the reference's constants set to the
    H100's (the reference module patched for the test only), the table
    row and the JSON equal the reference's."""
    for name, v in H100.items():
        monkeypatch.setattr(jrl, name, v)
    cells = [_cells(rl, **terms), _cells(rl, skipped=True,
                                         skip_reason="x")]
    jcells = [_cells(jrl, **terms), _cells(jrl, skipped=True,
                                           skip_reason="x")]
    assert rl.markdown_table(cells) == jrl.markdown_table(jcells)
    got = cells[0].to_json()
    assert got.pop("t_ideal") == pytest.approx(jcells[0].t_ideal)
    assert got == jcells[0].to_json()
    for s in (0.5e-6, 3.2e-3, 2.5):
        assert rl.fmt_seconds(s) == jrl.fmt_seconds(s)


def test_missing_terms_are_none_and_print_as_dashes():
    cell = _cells(rl, flops_per_chip=None, hbm_bytes_per_chip=None,
                  memory_per_chip_gb=None)
    assert cell.t_compute is None and cell.t_memory is None
    assert cell.t_collective == pytest.approx(4e9 / rl.ICI_BW)
    for prop in ("dominant", "useful_ratio", "roofline_fraction"):
        assert getattr(cell, prop) is None, prop
    assert cell.t_ideal == pytest.approx(max(
        5e16 / (256 * rl.PEAK_FLOPS), 1e13 / (256 * rl.HBM_BW)))
    row = rl.markdown_table([cell]).splitlines()[-1]
    cols = [c.strip() for c in row.strip("|").split("|")]
    assert cols[3:] == ["-", "-", "-", rl.fmt_seconds(cell.t_collective),
                        "-", "-", "-"]
    assert rl.fmt_seconds(None) == "-"
    js = cell.to_json()
    assert js["useful_ratio"] is None and js["roofline_fraction"] is None


@pytest.mark.parametrize("fn", ["parse_hlo_collectives", "collective_bytes",
                                "hlo_traffic_bytes"])
def test_hlo_parsers_raise_by_name(fn):
    with pytest.raises(NotImplementedError, match=fn):
        getattr(rl, fn)("HloModule m")


def test_ledger_collective_bytes_by_kind():
    """Bytes from a CoreEngine's ledger in the reference's kind names, the
    difference since an earlier table; a verb that moves nothing over a
    link is left out."""
    eng = CoreEngine()

    def route(verb, axes, n):
        eng.route(CommOp(verb=verb, axes=axes, size_bytes=n))

    route("psum", ("data",), 100)
    route("all_gather", ("data",), 40)
    before = eng.ledger_table()
    route("psum", ("data",), 100)
    route("psum", ("model",), 8)
    route("reduce_scatter", ("data",), 64)
    route("all_to_all", ("model",), 16)
    route("ppermute", ("pod",), 4)
    route("shm_move", ("data",), 1 << 20)
    total, kinds = rl.ledger_collective_bytes(eng, since=before)
    assert kinds == {"all-reduce": 108, "reduce-scatter": 64,
                     "all-to-all": 16, "collective-permute": 4}
    assert total == 192
    assert set(kinds) <= set(jrl.COLLECTIVES)
    assert rl.ledger_collective_bytes(eng.ledger_table())[0] == 332
    with pytest.raises(ValueError, match="bogus"):
        rl.ledger_collective_bytes([(0, "bogus", ("data",), 1, 1)])


def test_bound_ms():
    assert rl.bound_ms(rl.HBM_BW, 0.0, "bfloat16") == (1e3, "bytes")
    assert rl.bound_ms(0.0, rl.PEAK_FLOPS_BY_DTYPE["float32"],
                       "float32") == (1e3, "operations")
    ms, by = rl.bound_ms(1e9, 1e12, "bfloat16")
    assert by == "operations" and ms == pytest.approx(1e15 / 989e12)


def test_f32_on_the_tensor_cores_is_a_third_of_tf32():
    """f32 flash runs as three TF32 products on the tensor cores: its
    operations count at a third of the datasheet's dense TF32 rate."""
    assert rl.PEAK_FLOPS_TF32 == 495e12
    assert rl.PEAK_FLOPS_F32_TENSOR == pytest.approx(165e12)
    assert rl.bound_ms(0.0, 165e12, "float32",
                       rl.PEAK_FLOPS_F32_TENSOR) == (pytest.approx(1e3),
                                                     "operations")
    # without the rate the dtype's peak holds, as before
    assert rl.bound_ms(0.0, 67e12, "float32") == (pytest.approx(1e3),
                                                  "operations")
    assert rl.bound_ms(3.35e12, 1.0, "float32",
                       rl.PEAK_FLOPS_F32_TENSOR) == (pytest.approx(1e3),
                                                     "bytes")


# whisper-small's trained f32 flash shapes (B 4, 12/12 heads, d 64, T 1500
# frames) and their bounds at three TF32 products
@pytest.mark.parametrize("s,causal,want_ms", [(1500, False, 0.168),
                                              (448, True, 0.0075)])
def test_chip_smoke_bounds_f32_flash_at_the_tensor_core_rate(s, causal,
                                                             want_ms):
    import importlib.util
    import pathlib

    import torch

    from repro_torch.kernels.flash_attention import route
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    nbytes, flops = cs.flash_work(4, s, 1500, 12, 12, 64, 4, causal, 0)
    took = route(torch.float32, 64)
    assert took == "tf32x3"
    ms, by = cs.bound(nbytes, flops, "float32", took)
    assert by == "operations"
    assert ms == pytest.approx(flops / rl.PEAK_FLOPS_F32_TENSOR * 1e3)
    assert ms == pytest.approx(want_ms, rel=0.01)
    # the CUDA cores' f32 rate, the bound before the route existed
    assert cs.bound(nbytes, flops, "float32")[0] == pytest.approx(
        flops / 67e12 * 1e3)
    assert cs.bound(nbytes, flops, "bfloat16", "wgmma") == \
        rl.bound_ms(nbytes, flops, "bfloat16")
