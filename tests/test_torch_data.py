"""The port's synthetic image pipeline against the JAX package.

* ``prng.randint`` is ``jax.random.randint`` bit for bit (int32), over
  spans that are a power of two, that are not, that start below zero, the
  empty and the one-value span and the whole int32 range;
* ``ImageStream`` batches: labels bit for bit, images within
  ``IMAGE_ATOL`` (the noise is ``prng.normal``, at most 3 float32 ulps
  from jax's, and the gratings go through ``sin`` / ``cos``, whose float32
  results differ from XLA's by a few ulps at arguments up to ~40);
* a stream restored from ``state_dict`` at step k gives the batches of an
  uninterrupted one from step k on, bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import ImageStream as JaxImageStream
from repro_torch import prng
from repro_torch.data import ImageStream, make_image_batch

# sin(freq * grid + phase) at |arguments| <= ~40 (an ulp there is 3.8e-6
# in the argument, so ~2e-6 in the image), plus 0.1 * normal's 3 ulps
IMAGE_ATOL = 5e-6


@pytest.mark.parametrize("minval,maxval", [
    (0, 10), (0, 16), (-5, 7), (-1000, 1000003), (0, 1), (3, 3), (10, 2),
    (-2 ** 31, 2 ** 31 - 1), (0, 2 ** 31 - 1), (-2 ** 31, 0)])
@pytest.mark.parametrize("seed", [0, 123457])
def test_randint_matches_jax_bit_for_bit(seed, minval, maxval):
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (513,),
                                        minval, maxval))
    got = prng.randint(prng.PRNGKey(seed), (513,), minval, maxval)
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(OverflowError):
        prng.randint(prng.PRNGKey(0), (4,), 0, 2 ** 31)


@pytest.mark.parametrize("seed,batch,hw", [(0, 8, 32), (99, 16, 32),
                                           (3, 5, 17)])
def test_image_stream_matches_jax(seed, batch, hw):
    ref = JaxImageStream(hw=hw, global_batch=batch, seed=seed)
    port = ImageStream(hw=hw, global_batch=batch, seed=seed, device="cpu")
    for _ in range(3):
        bj, bt = ref.next_batch(), port.next_batch()
        assert bt["label"].dtype == torch.int32
        np.testing.assert_array_equal(bt["label"].numpy(),
                                      np.asarray(bj["label"]))
        assert bt["image"].shape == (batch, hw, hw, 3)
        assert bt["image"].dtype == torch.float32
        np.testing.assert_allclose(bt["image"].numpy(),
                                   np.asarray(bj["image"]), rtol=0,
                                   atol=IMAGE_ATOL)
    assert port.state_dict() == ref.state_dict()


def test_image_stream_resumes_from_state_dict():
    whole = ImageStream(global_batch=4, seed=5, device="cpu")
    batches = [whole.next_batch() for _ in range(5)]
    resumed = ImageStream(global_batch=4, device="cpu")
    first = ImageStream(global_batch=4, seed=5, device="cpu")
    for _ in range(2):
        first.next_batch()
    resumed.load_state_dict(first.state_dict())
    for b in batches[2:]:
        r = resumed.next_batch()
        assert torch.equal(r["image"], b["image"])
        assert torch.equal(r["label"], b["label"])


def test_make_image_batch_on_a_sharded_stream():
    """Shard s of n draws its own key: local batches of global_batch / n."""
    s0 = ImageStream(global_batch=8, num_shards=2, shard=0, device="cpu")
    s1 = ImageStream(global_batch=8, num_shards=2, shard=1, device="cpu")
    b0, b1 = s0.next_batch(), s1.next_batch()
    assert b0["image"].shape[0] == b1["image"].shape[0] == 4
    assert not torch.equal(b0["image"], b1["image"])
    key = prng.PRNGKey(hash((0, 0, 1, 7)) & 0x7FFFFFFF)
    again = make_image_batch(key, 4, 32, 3, 10, "cpu")
    assert torch.equal(again["image"], b1["image"])


def test_image_stream_runs_on_the_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageStream()
