"""The port's checkpoint manager (``repro_torch.checkpoint.manager``),
mirroring ``tests/test_checkpoint_fleet.py``: the dtype rules (int64
counters stay int64 numpy, bf16 round-trips through float32, tensors come
back as tensors on the template's device, Python scalars as 0-d arrays of
the matching numpy dtype), NamedTuples (``ChipMaps`` / ``DriftMaps``),
empty containers, list and tuple types, ``manifest()``, float extras bit
for bit, keep-K garbage collection and the async write. Every value
round-trips exactly."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.lifetime.drift import DriftMaps
from repro_torch.variation.chip import ChipMaps


def _roundtrip(tmp_path, tree, extra=None):
    m = CheckpointManager(str(tmp_path), async_write=False)
    m.save(0, {"t": tree}, extra=extra)
    out, got_extra = m.restore(0, {"t": tree})
    return out["t"], got_extra


class TestDtypeRestoration:
    def test_integer_arrays_come_back_integer(self, tmp_path):
        tree = {"ages": np.arange(5, dtype=np.int64),
                "mask": np.array([True, False]),
                "ticks": torch.arange(3, dtype=torch.int16)}
        out, _ = _roundtrip(tmp_path, tree)
        assert out["ages"].dtype == np.int64
        assert out["mask"].dtype == np.bool_
        assert out["ticks"].dtype == torch.int16
        assert np.array_equal(out["ages"], tree["ages"])
        assert torch.equal(out["ticks"], tree["ticks"])

    def test_int64_counters_stay_numpy(self, tmp_path):
        big = np.array([2 ** 40], dtype=np.int64)
        out, _ = _roundtrip(tmp_path, {"clock": big})
        assert isinstance(out["clock"], np.ndarray)
        assert out["clock"].dtype == np.int64
        assert out["clock"][0] == 2 ** 40

    def test_bf16_roundtrips_through_f32_widening(self, tmp_path):
        x = torch.tensor([0.5, 1.25, -3.0], dtype=torch.bfloat16)
        out, _ = _roundtrip(tmp_path, {"w": x})
        assert out["w"].dtype == torch.bfloat16
        assert torch.equal(out["w"], x)
        with np.load(tmp_path / "step_0" / "t.npz") as data:
            assert data["w"].dtype == np.float32

    def test_tensor_template_restores_as_tensor_on_its_device(self, tmp_path):
        trim = torch.ones((4,), dtype=torch.float32)
        out, _ = _roundtrip(tmp_path, {"trim": trim})
        assert isinstance(out["trim"], torch.Tensor)
        assert out["trim"].device == trim.device
        assert torch.equal(out["trim"], trim)

    def test_python_scalars_restore_matching_dtype(self, tmp_path):
        out, _ = _roundtrip(tmp_path, {"count": 7, "energy": 1.5,
                                       "flag": True})
        assert int(out["count"]) == 7
        assert np.asarray(out["count"]).dtype == np.int64
        assert float(out["energy"]) == 1.5
        assert bool(out["flag"]) is True
        assert np.asarray(out["flag"]).dtype == np.bool_


class TestStructuredTrees:
    def test_chipmaps_namedtuple_roundtrips(self, tmp_path):
        gen = torch.Generator().manual_seed(0)
        chip = ChipMaps(*[torch.randn((4, 8) if i < 4 else (4,),
                                      generator=gen) for i in range(6)])
        out, _ = _roundtrip(tmp_path, {"chip": chip})
        assert isinstance(out["chip"], ChipMaps)
        for a, b in zip(out["chip"], chip):
            assert torch.equal(a, b)

    def test_stacked_fleet_tree_roundtrips(self, tmp_path):
        """A fleet checkpoint's shape: stacked NamedTuples of tensors and
        host telemetry arrays in one tree."""
        f, c, n = 3, 4, 8
        z = lambda *s: torch.ones(s)
        tree = {"chips0": ChipMaps(z(f, c, n), z(f, c, n), z(f, c, n),
                                   z(f, c, n), z(f, c), z(f, c)),
                "maps": DriftMaps(z(f, c, n), z(f, c, n), z(f, c, n),
                                  z(f, c, n), z(f, c), z(f, c)),
                "trim": z(f, c),
                "age_frames": np.array([10, 0, 99], np.int64)}
        out, _ = _roundtrip(tmp_path, tree)
        assert isinstance(out["chips0"], ChipMaps)
        assert isinstance(out["maps"], DriftMaps)
        assert out["age_frames"].dtype == np.int64
        assert np.array_equal(out["age_frames"], tree["age_frames"])
        with np.load(tmp_path / "step_0" / "t.npz") as data:
            assert "chips0/__0" in data.files and "maps/__5" in data.files

    def test_empty_dict_and_list_survive(self, tmp_path):
        tree = {"empty": {}, "items": [], "nested": {"also": {}},
                "x": np.ones((2,))}
        out, _ = _roundtrip(tmp_path, tree)
        assert out["empty"] == {}
        assert out["items"] == []
        assert out["nested"] == {"also": {}}

    def test_tuple_and_list_types_preserved(self, tmp_path):
        tree = {"tup": (np.ones((2,)), np.zeros((3,))),
                "lst": [torch.ones((1,))]}
        out, _ = _roundtrip(tmp_path, tree)
        assert isinstance(out["tup"], tuple)
        assert isinstance(out["lst"], list)


class TestManifestAndLifecycle:
    def test_manifest_reads_extra_without_restoring(self, tmp_path):
        extra = {"chip_ids": [3, 1, 4], "seed": 0,
                 "theta_carry": {"3": 0.57}}
        m = CheckpointManager(str(tmp_path), async_write=False)
        m.save(2, {"t": {"x": np.ones((2,))}}, extra=extra)
        man = m.manifest(2)
        assert man["step"] == 2
        assert man["extra"]["chip_ids"] == [3, 1, 4]
        assert man["extra"]["theta_carry"]["3"] == 0.57
        assert man["trees"] == ["t"]

    def test_manifest_missing_step_raises(self, tmp_path):
        m = CheckpointManager(str(tmp_path), async_write=False)
        with pytest.raises(FileNotFoundError):
            m.manifest(5)

    def test_float_extra_roundtrips_exactly(self, tmp_path):
        v = 0.5706748198690934
        m = CheckpointManager(str(tmp_path), async_write=False)
        m.save(0, {"t": {"x": np.ones(1)}}, extra={"carry": v})
        assert m.manifest(0)["extra"]["carry"] == v

    def test_keep_k_collects_old_steps_and_leaves_no_tmp(self, tmp_path):
        m = CheckpointManager(str(tmp_path), keep=2, async_write=False)
        for step in range(5):
            m.save(step, {"t": {"x": np.full((2,), step)}})
        assert m.all_steps() == [3, 4] and m.latest_step() == 4
        assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path))
        out, _ = m.restore(4, {"t": {"x": np.zeros((2,))}})
        assert np.array_equal(out["t"]["x"], [4.0, 4.0])

    def test_async_write_lands_after_wait(self, tmp_path):
        m = CheckpointManager(str(tmp_path), async_write=True)
        x = torch.arange(6, dtype=torch.float32)
        m.save(1, {"t": {"x": x}}, extra={"k": 1})
        m.wait()
        with open(tmp_path / "step_1" / "manifest.json") as f:
            assert json.load(f)["extra"] == {"k": 1}
        out, _ = m.restore(1, {"t": {"x": torch.zeros(6)}})
        assert torch.equal(out["t"]["x"], x)
