"""The port's per-shape frontend table against the reference's semantics.

``repro_torch.kernels.autotune`` keeps what the CUDA kernels use of the
reference's ``TileChoice``: the fused flag and the precision. Each test runs
on an emptied process table (the table is process-global, as the
reference's is, and xdist runs many files in one worker).
"""
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as j_autotune
from repro_torch import prng
from repro_torch.kernels import autotune
from repro_torch.kernels import ops
from repro_torch.models import vision as tv
from repro_torch.serving import VisionEngine


@pytest.fixture(autouse=True)
def empty_table(monkeypatch):
    monkeypatch.setattr(autotune, "_TABLE", {})


def test_save_load_round_trip(tmp_path):
    a = autotune.TileChoice(fused=False, precision="int8")
    b = autotune.TileChoice(fused=True, precision="f32")
    autotune.put(4096, 27, 32, a)
    autotune.put(1024, 27, 32, b)
    path = tmp_path / "tiles.json"
    autotune.save_table(str(path))
    raw = json.loads(path.read_text())
    # the stamp is obs.export.bench_meta's block
    assert raw["_meta"]["torch_version"] == torch.__version__
    assert raw["_meta"]["bench"] == "autotune"
    assert {"device", "nvidia_smi", "entries"} <= set(raw["_meta"])
    autotune.clear()
    assert autotune.lookup(4096, 27, 32) is None
    assert autotune.load_table(str(path)) == 2
    assert autotune.lookup(4096, 27, 32) == a
    assert autotune.lookup(1024, 27, 32) == b
    assert autotune.TileChoice.from_json(a.to_json()) == a


def test_loads_a_reference_table_ignoring_tpu_block_sizes(tmp_path):
    """A table the reference wrote carries TPU block sizes; the port keeps
    its fused flag and precision, and a pre-int8 entry loads as f32."""
    ref = j_autotune.TileChoice(block_n=512, block_n_elem=4096,
                                block_n_fused=0, fused=False,
                                precision="int8").to_json()
    legacy = {"block_n": 512, "block_n_elem": 4096, "fused": True}
    path = tmp_path / "ref_tiles.json"
    path.write_text(json.dumps({"4096,27,32": ref, "512,27,32": legacy,
                                "_meta": {"backend": "cpu"}}))
    assert autotune.load_table(str(path)) == 2
    assert autotune.lookup(4096, 27, 32) == autotune.TileChoice(
        fused=False, precision="int8")
    assert autotune.lookup(512, 27, 32).precision == "f32"


def test_explicit_precision_wins_and_is_validated():
    autotune.put(4096, 27, 32, autotune.TileChoice(precision="int8"))
    assert autotune.resolve_precision(4096, 27, 32, "f32") == "f32"
    assert autotune.resolve_precision(4096, 27, 32, None) == "int8"
    assert autotune.resolve_precision(4096, 27, 32, "int8") == "int8"
    for bad in ("fp8", "bf16"):
        with pytest.raises(ValueError, match="precision"):
            autotune.resolve_precision(4096, 27, 32, bad)
        with pytest.raises(ValueError, match="precision"):
            autotune.put(1, 2, 3, autotune.TileChoice(precision=bad))
    # the reference resolves the same way
    assert j_autotune.resolve_precision(4096, 27, 32, "int8") == "int8"
    with pytest.raises(ValueError, match="precision"):
        j_autotune.resolve_precision(4096, 27, 32, "fp8")


def test_untuned_shape_gives_f32_and_fused_and_is_recorded():
    assert autotune.lookup(777, 27, 32) is None
    choice = autotune.get(777, 27, 32)
    assert (choice.fused, choice.precision) == (True, "f32")
    assert autotune.lookup(777, 27, 32) is choice
    assert autotune.resolve_precision(777, 27, 32) == "f32"
    ref = j_autotune.default_choice(777, 27, 32)
    assert (ref.fused, ref.precision) == (choice.fused, choice.precision)


def test_frontend_precision_defers_to_the_table():
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(size=(2, 16, 16, 3))
                              .astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, 8)) * 0.3)
                         .astype(np.float32))
    key = prng.PRNGKey(1)
    o8, aux8 = ops.p2m_frontend(images, w, torch.ones(()), key,
                                precision="int8")
    o32, aux32 = ops.p2m_frontend(images, w, torch.ones(()), key,
                                  precision="f32")
    assert not torch.equal(aux8["theta"], aux32["theta"])
    autotune.put(2 * 8 * 8, 27, 8, autotune.TileChoice(precision="int8"))
    o, aux = ops.p2m_frontend(images, w, torch.ones(()), key)
    assert torch.equal(o, o8) and torch.equal(aux["theta"], aux8["theta"])
    of, _ = ops.p2m_frontend_fused(images, w, torch.ones(()), aux8["theta"],
                                   key)
    assert torch.equal(of, o8)


@pytest.mark.parametrize("fused", [True, False])
def test_engine_stream_reads_fused_from_the_table(tmp_path, fused):
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny")
    autotune.put(2 * 16 * 16, 27, 32, autotune.TileChoice(fused=fused))
    path = tmp_path / "tiles.json"
    autotune.save_table(str(path))
    autotune.clear()
    engine = VisionEngine(cfg, tv.init_params(0, cfg), device="cpu",
                          microbatch=2, fused_theta_tol=1e9,
                          tile_table=str(path))
    frames = torch.rand(6, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(2))
    (out,) = list(engine.stream([frames]))
    assert engine.fused_step_count == (2 if fused else 0)
    assert float(out["stream_fused"]) == pytest.approx(2 / 3 if fused else 0)


def test_search_needs_the_card():
    images = torch.rand(2, 8, 8, 3)
    with pytest.raises(RuntimeError, match="card"):
        autotune.autotune_frontend(images, torch.randn(3, 3, 3, 8),
                                   torch.ones(()), prng.PRNGKey(0))
