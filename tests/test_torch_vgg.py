"""The port's VGG model (distributed_pytorch_tpu_torch models/vgg.py,
ops/nn.py, convert.py's VGG trees) against the JAX package's, on the CPU.

Both packages run the same weights (the JAX package's init, carried by
convert.py: HWIO -> OIHW channels_last) on the same seed-made inputs.
float32 agrees to rtol 1e-5 / atol 1e-5 (convolution summation order);
bfloat16 to 5% of the logits' scale (XLA and oneDNN round the bf16
convolutions at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.data import augment as jaug
from distributed_pytorch_tpu.models import vgg as jvgg
from distributed_pytorch_tpu.ops import nn as jnn
from distributed_pytorch_tpu_torch import convert
from distributed_pytorch_tpu_torch.data import augment as taug
from distributed_pytorch_tpu_torch.models import vgg as tvgg
from distributed_pytorch_tpu_torch.ops import fused_bn as tfused
from distributed_pytorch_tpu_torch.ops import nn as tnn

F32 = dict(rtol=1e-5, atol=1e-5)
_japply = jax.jit(jvgg.apply, static_argnames=("name", "train", "dtype",
                                               "fused_bn"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU shapes: parallel test workers
    each running torch's default thread pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """The JAX package's TINY init, its port, and a seed-made batch."""
    params, state = jvgg.init(jax.random.key(0), "TINY")
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (16, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    return params, state, images, labels


def _port(params, state):
    return convert.from_jax_vgg(params, state, device="cpu")


def _close(got: dict, want: dict, **tol):
    want_t, _ = convert.from_jax_vgg(want, {}, device="cpu")
    for k, v in got.items():
        for n, t in v.items():
            np.testing.assert_allclose(t.detach().float().numpy(),
                                       want_t[k][n].numpy(),
                                       err_msg=f"{k}.{n}", **tol)


def test_vgg11_counts_and_shapes_match_jax():
    jp, js = jax.eval_shape(lambda k: jvgg.init(k, "VGG11"),
                            jax.random.key(0))
    tp, ts = tvgg.init(0, "VGG11", device="cpu")
    assert tvgg.tensor_count(tp) == jvgg.tensor_count(jp) == 34
    assert tvgg.param_count(tp) == jvgg.param_count(jp)
    assert abs(tvgg.param_count(tp) - 9.23e6) < 0.01e6
    want_p, want_s = _port(*(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), t) for t in (jp, js)))
    for got, want in ((tp, want_p), (ts, want_s)):
        assert sorted(got) == sorted(want)
        for k in got:
            for n in got[k]:
                assert got[k][n].shape == want[k][n].shape, (k, n)
                assert got[k][n].dtype == torch.float32
    assert tp["conv3"]["kernel"].is_contiguous(
        memory_format=torch.channels_last)
    # torch-default init bounds: kaiming-uniform(a=sqrt(5)) and fan-in bias
    fan_in = 3 * 3 * 128
    for n in ("kernel", "bias"):
        bound = (1.0 / fan_in) ** 0.5
        assert tp["conv2"][n].abs().max() <= bound
        assert tp["conv2"][n].abs().max() > 0.9 * bound
    assert torch.equal(ts["bn0"]["var"], torch.ones(64))
    again, _ = tvgg.init(0, "VGG11", device="cpu")
    assert torch.equal(again["fc"]["kernel"], tp["fc"]["kernel"])


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvgg.init(0, "TINY")


def test_convert_round_trips_exactly(tiny):
    params, state, _, _ = tiny
    tp, ts = _port(params, state)
    assert tp["conv0"]["kernel"].shape == (8, 3, 3, 3)
    assert tp["conv0"]["kernel"].is_contiguous(
        memory_format=torch.channels_last)
    back_p, back_s = convert.to_jax_vgg(tp, ts)
    for want, got in ((params, back_p), (state, back_s)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax_f32(tiny, train):
    """TINY logits and new BN state against the JAX package, in train mode
    and in eval mode (eval from a non-trivial running state)."""
    params, state, images, _ = tiny
    if not train:
        _, state = _japply(params, state, jaug.normalize(images),
                           name="TINY", train=True)
        state = jax.tree.map(np.asarray, state)
    want, want_state = _japply(params, state, jaug.normalize(images),
                               name="TINY", train=train)
    tp, ts = _port(params, state)
    got, got_state = tvgg.apply(tp, ts, taug.normalize(
        torch.from_numpy(images)), name="TINY", train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    _close(got_state, jax.tree.map(np.asarray, want_state), **F32)


def test_forward_matches_jax_bf16(tiny):
    params, state, images, _ = tiny
    want, want_state = _japply(params, state, jaug.normalize(images),
                               name="TINY", train=True, dtype=jnp.bfloat16)
    tp, ts = _port(params, state)
    got, got_state = tvgg.apply(tp, ts, taug.normalize(
        torch.from_numpy(images)), name="TINY", train=True,
        dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-2 * scale)
    _close(got_state, jax.tree.map(np.asarray, want_state), rtol=5e-2,
           atol=5e-2)


def test_fold_bn_matches_jax(tiny):
    params, state, images, _ = tiny
    _, state = _japply(params, state, jaug.normalize(images), name="TINY",
                       train=True)
    state = jax.tree.map(np.asarray, state)
    folded = jvgg.fold_bn(params, state, name="TINY")
    want = jvgg.apply_folded(folded, jaug.normalize(images), name="TINY")
    tp, ts = _port(params, state)
    tfold = tvgg.fold_bn(tp, ts, name="TINY")
    _close({k: v for k, v in tfold.items()},
           jax.tree.map(np.asarray, folded), **F32)
    got = tvgg.apply_folded(tfold, taug.normalize(torch.from_numpy(images)),
                            name="TINY")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    plain, _ = tvgg.apply(tp, ts, taug.normalize(torch.from_numpy(images)),
                          name="TINY", train=False)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32)


def test_fused_step_matches_plain_and_jax(tiny):
    """One TINY train step with fused_bn=True: the plain step's loss bit
    for bit and its gradients to float32 noise; both against the JAX
    package's step, to tests/test_fused_bn.py's integration tolerance,
    rtol 3e-5 / atol 2e-5 (the JAX fused step equals its plain one there,
    and the BN-level tests here hold the port against the JAX fused VJP)."""
    params, state, images, labels = tiny
    x = jaug.normalize(images)

    @jax.jit
    def jloss(p):
        logits, _ = jvgg.apply(p, state, x, name="TINY", train=True)
        return jnn.cross_entropy_loss(logits, jnp.asarray(labels))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    runs = []
    for fused in (False, True):
        tp, ts = _port(params, state)
        for v in tp.values():
            for t in v.values():
                t.requires_grad_(True)
        logits, _ = tvgg.apply(tp, ts, taug.normalize(
            torch.from_numpy(images)), name="TINY", train=True,
            fused_bn=fused)
        loss = tnn.cross_entropy_loss(logits, torch.from_numpy(labels))
        loss.backward()
        runs.append((loss.detach(), {k: {n: t.grad for n, t in v.items()}
                                     for k, v in tp.items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    np.testing.assert_allclose(float(runs[1][0]), float(jl), rtol=1e-6)
    tol = dict(rtol=3e-5, atol=2e-5)
    _close(runs[1][1], jax.tree.map(np.asarray, jg), **tol)
    for k, v in runs[0][1].items():
        for n, g in v.items():
            np.testing.assert_allclose(runs[1][1][k][n].numpy(), g.numpy(),
                                       err_msg=f"{k}.{n}", **tol)


def test_apply_refuses_later_slice_knobs(tiny):
    params, state, images, _ = tiny
    tp, ts = _port(params, state)
    x = taug.normalize(torch.from_numpy(images))
    # sync-BN is slice 5a's: a one-rank group gives local BN bit for bit,
    # and the fused backward refuses it, as the JAX kernel's envelope does
    import torch.distributed as dist
    from distributed_pytorch_tpu_torch.parallel import init as pinit
    from distributed_pytorch_tpu_torch.parallel.mesh import make_mesh
    created = not dist.is_initialized()
    group = make_mesh(device="cpu").get_group()
    try:
        got, got_st = tvgg.apply(tp, ts, x, name="TINY", train=True,
                                 bn_axis_name=group)
        want, want_st = tvgg.apply(tp, ts, x, name="TINY", train=True)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="does not cover"):
            tvgg.apply(tp, ts, x, name="TINY", train=True,
                       bn_axis_name=group, fused_bn=True)
    finally:
        if created:
            pinit.shutdown()
    # the overlapped gradient sync's hook: called at every layer group in
    # forward order (JAX sync_group_index), an identity on values
    seen = []
    got, _ = tvgg.apply(tp, ts, x, name="TINY", train=True,
                        boundary=lambda i, p: seen.append(i) or p)
    want, _ = tvgg.apply(tp, ts, x, name="TINY", train=True)
    assert torch.equal(got, want)
    assert seen == sorted(set(tvgg.sync_group_index("TINY").values()))


def test_activations_stay_channels_last(tiny):
    """Every BN input the fused backward sees is channels_last, so K1a/K1b
    read it as (M, C) rows without a copy (the gradient's layout is
    autograd's: chip_smoke.py counts any copy on the card)."""
    params, state, images, labels = tiny
    tp, ts = _port(params, state)
    for v in tp.values():
        for t in v.values():
            t.requires_grad_(True)
    seen = []
    orig = tfused.bn_relu_bwd

    def spy(dr, a, *rest):
        seen.append((a.is_contiguous(memory_format=torch.channels_last),
                     dr.is_contiguous(memory_format=torch.channels_last)))
        return orig(dr, a, *rest)

    tfused.bn_relu_bwd = spy
    try:
        logits, _ = tvgg.apply(tp, ts, taug.normalize(
            torch.from_numpy(images)), name="TINY", train=True,
            fused_bn=True)
        tnn.cross_entropy_loss(logits, torch.from_numpy(labels)).backward()
    finally:
        tfused.bn_relu_bwd = orig
    assert len(seen) == 8 and all(a for a, _ in seen)
