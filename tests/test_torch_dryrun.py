"""The port's dry run against the reference's, on the CPU.

The reference compiles each cell against 512 placeholder devices; the port
builds one rank's shard on the meta device. Held here:

* ``run_config_for`` equals the reference's field for field in every
  (arch x shape) cell.
* Each applicable cell's per-rank parameter bytes, on 16x16 and 2x16x16,
  equal the reference's spec math (its ``model_schema``, ``spec_for`` and
  ``strip_axes_from_rules`` on a ``_FakeMesh``, as
  ``tests/test_torch_sharding.py`` does): training cells in the rules'
  layout, serving cells in the port's (weights replicated over the batch
  axes) with the reference's layout beside it; the cache bytes the
  reference's ``cache_schema`` by the same rules.
* The train state's per-rank bytes (params, moments, batch) equal
  ``NamedSharding.shard_shape`` of the reference's ``state_shardings`` and
  ``batch_shardings`` on the 8-device host mesh (``mesh8``, data 2 x
  model 4), for each family's smoke config under the numerics
  ``run_config_for`` gives its full config's ``train_4k`` cell. Sharding
  the abstract state compiles nothing.
* The CLI's records and report, the refusals by name, ``"meta"`` admitted
  by ``resolve_device`` only when asked for, and ``chip_smoke.py``'s
  launch phase rehearsed on the CPU (its card-only materialisation left
  out).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported: it is imported inside a fixture, after ``jax.devices()`` has
fixed the backend at conftest's 8, with the variable restored after.
"""
import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconf
from repro.distribution.sharding import ParamDesc as JParamDesc
from repro.distribution.sharding import make_rules as j_make_rules
from repro.distribution.sharding import spec_for as j_spec_for
from repro.distribution.sharding import \
    strip_axes_from_rules as j_strip_axes_from_rules
from repro.models.model import cache_schema as j_cache_schema
from repro.models.model import input_specs as j_input_specs
from repro.models.model import model_schema as j_model_schema
from repro.train.train_loop import batch_shardings as j_batch_shardings
from repro.train.train_loop import make_train_state as j_make_state
from repro.train.train_loop import state_shardings as j_state_shardings
from repro_torch.configs import (ARCHS, SHAPES, ShapeConfig,
                                 get_smoke_config)
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import ICI_BW

from _torch_threads import one_thread  # noqa: F401

FAMILY_ARCHS = ("llama3.2-3b", "chameleon-34b", "nemotron-4-340b",
                "arctic-480b", "deepseek-v2-236b", "mamba2-370m",
                "hymba-1.5b", "whisper-small")


@pytest.fixture(scope="module")
def jdryrun():
    jax.devices()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        import repro.launch.dryrun as jd
    return jd


class _FakeMesh:
    """Only axis sizes matter for the reference's spec math."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.devices = np.zeros(tuple(axes.values()))


def _ref_bytes(tree, sizes, rules) -> int:
    """A rank's bytes of a reference schema, every leaf laid out by
    ``rules`` on ``sizes`` (its ``spec_for`` on a ``_FakeMesh``)."""
    fake = _FakeMesh(**sizes)
    total = 0
    for desc in jax.tree.leaves(tree,
                                is_leaf=lambda x: isinstance(x, JParamDesc)):
        spec = tuple(j_spec_for(desc.shape, desc.dims, fake, rules))
        n = 1
        for i, d in enumerate(desc.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else \
                (entry if isinstance(entry, tuple) else (entry,))
            n *= d // math.prod(sizes[a] for a in axes)
        total += n * np.dtype(jax.numpy.dtype(desc.dtype)).itemsize
    return total


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_run_config_for_equals_the_reference(arch, jdryrun):
    for shape in SHAPES:
        got = dataclasses.asdict(dryrun.run_config_for(arch, shape))
        want = dataclasses.asdict(jdryrun.run_config_for(arch, shape))
        assert got == want, (arch, shape)
        assert dataclasses.asdict(dryrun.run_config_for(
            arch, shape, probe=True)) == dataclasses.asdict(
            jdryrun.run_config_for(arch, shape, probe=True))


@pytest.mark.parametrize("mesh", sorted(dryrun.MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_rank_bytes_equal_the_reference_spec_math(arch, mesh, jdryrun):
    sizes = dryrun.MESHES[mesh]
    jcfg = jconf.get_config(arch)
    jschema = j_model_schema(jcfg, _FakeMesh(**sizes))
    for name, shape in SHAPES.items():
        rec = dryrun.run_cell(arch, name, mesh == "2x16x16", write=False)
        ok, _ = jconf.shape_applicable(jcfg, jconf.get_shape(name))
        assert rec["skipped"] == (not ok)
        if not ok:
            continue
        rules = j_make_rules(jdryrun.run_config_for(arch, name)
                             .rules_variant)
        m = rec["memory"]
        whole = _ref_bytes(jschema, sizes, rules)
        assert m["params_bytes_reference_layout"] == whole, name
        if shape.kind == "train":
            assert m["params_bytes"] == whole, name
            continue
        served = _ref_bytes(jschema, sizes,
                            j_strip_axes_from_rules(("pod", "data"), rules))
        assert m["params_bytes"] == served, name
        assert m["cache_bytes"] == _ref_bytes(j_cache_schema(
            jcfg, shape.global_batch, shape.seq_len), sizes, rules), name
        assert m["resident_bytes"] == m["argument_bytes"] \
            + m["output_bytes"] - m["in_place_bytes"]
        assert m["state_fits_80gb"] == (m["resident_bytes"] < 80e9)


def _shard_bytes(tree, shardings) -> int:
    return sum(jax.tree.leaves(jax.tree.map(
        lambda a, s: math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize,
        tree, shardings)))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_state_bytes_equal_the_reference_shardings(arch, jdryrun,
                                                         mesh8):
    rcfg = dryrun.run_config_for(arch, "train_4k")
    jrcfg = jdryrun.run_config_for(arch, "train_4k")
    jcfg = jconf.get_smoke_config(arch)
    shape = ShapeConfig("t", 64, 8, "train")
    cell = dryrun.build_cell(get_smoke_config(arch), shape,
                             {"data": 2, "model": 4}, rcfg)
    state = cell["arguments"]["state"]
    jstate = j_make_state(jcfg, jrcfg, mesh8, abstract=True)
    ssh = j_state_shardings(jcfg, jrcfg, mesh8)
    for got, tree, sh in (
            (state["params"], jstate["params"], ssh["params"]),
            (state["opt"]["mu"], jstate["opt"]["mu"], ssh["opt"]["mu"]),
            (state["opt"]["nu"], jstate["opt"]["nu"], ssh["opt"]["nu"])):
        assert dryrun.nbytes(got) == _shard_bytes(tree, sh)
    assert {t.device.type for t in dryrun.tensors(state)} == {"meta"}
    jshape = jconf.ShapeConfig("t", 64, 8, "train")
    bsh = j_batch_shardings(jcfg, mesh8, rcfg=jrcfg, global_batch=8)
    specs = j_input_specs(jcfg, jshape)
    assert dryrun.nbytes(cell["arguments"]["batch"]) == _shard_bytes(
        {k: specs[k] for k in bsh}, bsh)


def test_cli_records_and_report(tmp_path):
    out = str(tmp_path)
    dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k",
                 "--out", out])
    dryrun.main(["--arch", "llama3.2-3b", "--shape", "long_500k",
                 "--multi-pod", "--out", out])
    with open(tmp_path / "llama3.2-3b__decode_32k__16x16.json") as f:
        rec = json.load(f)
    roof = rec["roofline"]
    for key in ("flops_per_chip", "hbm_bytes_per_chip", "coll_bytes_per_chip",
                "t_compute", "t_memory", "t_collective", "dominant",
                "useful_ratio", "roofline_fraction"):
        assert roof[key] is None, key
    assert roof["t_ideal"] > 0 and rec["rules_variant"] == "tp"
    assert rec["memory"]["temp_bytes"].startswith("not modelled")
    with open(tmp_path / "llama3.2-3b__long_500k__2x16x16.json") as f:
        assert json.load(f)["skipped"]
    table = dryrun.report(out).splitlines()
    assert len(table) == 4 and "| tp |" in table[2] and "SKIP" in table[3]


def test_probes_and_cost_analysis_raise_by_name():
    from repro_torch.configs import get_config, get_shape
    args = (get_config("llama3.2-3b"), get_shape("train_4k"),
            dryrun.MESHES["16x16"])
    for fn in (dryrun.run_probes, dryrun.cost_analysis):
        with pytest.raises(NotImplementedError, match=fn.__name__):
            fn(*args)


def test_meta_is_admitted_only_when_asked_for(monkeypatch):
    assert resolve_device("meta").type == "meta"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


def test_launch_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s launch phase on the CPU at llama's smoke config:
    the dry-run table (llama's cells), the roofline floors beside given
    medians, and remat "dots" against "full" at S 32 and 2 layers, one
    timed pass each (the plain kernel wrapped to count launches; torch.cuda's synchronize and
    memory calls stubbed). The cells made on the card are left out
    (``cells=()``)."""
    import importlib.util
    import pathlib

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 32)
    monkeypatch.setattr(cs, "DOTS_LAYERS", 2)
    monkeypatch.setattr(cs, "DOTS_TIMED", 1)
    real = attention.flash_attention

    def counted(*args, **kw):
        fa.flash_attention.launches += 1
        return real(*args, **kw)

    monkeypatch.setattr(attention, "flash_attention", counted)
    rows = []
    monkeypatch.setattr(cs, "emit", rows.append)
    cfg = get_smoke_config("llama3.2-3b")
    serve = {"max_seq": 64, "slots": 8, "step_ms_median": 2.0}
    train = {"step_ms_median": 40.0}
    sharded = {"layers": 2, "step_ms_sharded": [80.0, 70.0],
               "ledger_bytes_a_step": 4096,
               "ledger_bytes_a_step_by_kind": {"all-reduce": 4096}}
    out = cs.phase_launch(torch, torch.device("cpu"), "cpu", cfg, serve,
                          train, sharded, archs=("llama3.2-3b",), cells=())
    by = {r["check"]: r for r in rows if r["check"] != "roofline"}
    assert by["dryrun"]["cells"] == 8 and by["dryrun"]["skipped"] == 2
    assert by["dryrun"]["not_fitting_80gb"] == []
    assert ("llama3.2-3b", "prefill_32k", "16x16") in \
        by["dryrun"]["serving_layout_differs"]
    floors = out["roofline"]
    assert [r["case"] for r in floors] == ["decode", "train",
                                           "sharded train, world 1"]
    assert floors[2]["t_collective_ms"] == pytest.approx(
        4096 / ICI_BW * 1e3)
    assert floors[0]["t_collective_ms"] is None
    dots = by["remat_dots_vs_full"]
    assert dots["worst_grad_gap"] == 0.0
    assert dots["full"]["flash_launches"] == dots["dots"]["flash_launches"] \
        == 2 * cfg.num_layers
    assert out["materialised"] == []

