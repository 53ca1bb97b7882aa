"""The port's VLM (``internvl2-1b``) and encoder-decoder audio
(``whisper-small``) families against the reference, on the CPU.

Reduced configs in fp32.  Parameters: the reference's ``init_params``
(PRNGKey 0) for the layout and scales, every leaf then moved by a numpy
draw from a seed (so LayerNorm biases, the gelu MLP's biases and the norms'
gains are off their init values), loaded into both packages
(``lm_params_from_numpy`` for the port); tokens, vision embeddings and
frames drawn with numpy.  Bounds: 1e-5 of the largest |value| for
activations, logits, encoder outputs and cache leaves, and for each
gradient leaf against ``jax.grad`` of the reference's ``loss_fn``.

Also: ``layer_norm``, ``gelu_mlp`` (the tanh approximation, ``jax.nn``'s
default) and ``sinusoidal_positions``; whisper's decode against a cross
cache written from the encoder output in both packages; the reference's
VLM integration test (``tests/test_transform_linear.py``) on the port,
its vision embeddings from block-DCT coefficients through
``fold_patch_embed``; ``serve_lm``'s report for the three new archs.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as RC
from repro.core import jpeg as ref_jpeg
from repro.core import transform_linear as ref_tl
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.models import layers as RL
from repro.models import registry as RR
from repro.models import transformer as RT
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import transform_linear as tl
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.optim import value_and_grad
from repro_torch.tree import leaves_with_paths

ARCHS = ["internvl2-1b", "whisper-small"]
RTOL = 1e-5
B, S = 2, 24


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _paths(flat) -> list[str]:
    return ["/".join(str(k) for k in path) for path, _ in flat]


def _draw(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_layer_norm_matches_reference():
    x, w, b = _draw(0, 3, 5, 48, scale=3.0), _draw(1, 48), _draw(2, 48)
    want = RL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = L.layer_norm(*map(torch.from_numpy, (x, w, b)))
    assert _rel(got.numpy(), want) < RTOL
    xb = torch.from_numpy(x).bfloat16()
    assert L.layer_norm(xb, torch.from_numpy(w),
                        torch.from_numpy(b)).dtype == torch.bfloat16


def test_gelu_mlp_is_the_tanh_approximation_of_the_reference():
    x = _draw(3, 2, 7, 32, scale=2.0)
    wi, bi, wo, bo = (_draw(4, 32, 64, scale=0.3), _draw(5, 64),
                      _draw(6, 64, 32, scale=0.2), _draw(7, 32))
    want = RL.gelu_mlp(*map(jnp.asarray, (x, wi, bi, wo, bo)))
    got = L.gelu_mlp(*map(torch.from_numpy, (x, wi, bi, wo, bo)))
    assert _rel(got.numpy(), want) < RTOL
    # the activation alone (identity weights, zero biases): jax.nn.gelu's
    # tanh form, which the erf form misses by up to ~5e-4
    z = np.linspace(-5, 5, 32 * 40, dtype=np.float32).reshape(1, 40, 32)
    eye, zero = np.eye(32, dtype=np.float32), np.zeros(32, np.float32)
    act = L.gelu_mlp(*map(torch.from_numpy, (z, eye, zero, eye, zero)))
    want_act = np.asarray(jax.nn.gelu(jnp.asarray(z)))
    assert np.abs(act.numpy() - want_act).max() < 1e-6
    erf = torch.nn.functional.gelu(torch.from_numpy(z)).numpy()
    assert np.abs(erf - want_act).max() > 1e-4


@pytest.mark.parametrize("dim", [64, 768])
def test_sinusoidal_positions_match_reference(dim):
    """Within 1e-5 over the first 64 positions.  Over whisper's 1500 the
    two packages' fp32 ``exp`` may round a frequency one ulp apart, and the
    angle pos·freq (up to 1499 rad) then one ulp of the angle apart: so
    there the bound is that ulp, 2^-13."""
    pos = np.arange(1500, dtype=np.int32)
    want = np.asarray(RL.sinusoidal_positions(jnp.asarray(pos), dim))
    got = L.sinusoidal_positions(torch.from_numpy(pos), dim).numpy()
    assert got.shape == (1500, dim) and got.dtype == np.float32
    assert np.abs(got[:64] - want[:64]).max() < RTOL
    assert np.abs(got - want).max() <= np.spacing(np.float32(pos[-1]))


def numpy_params(rcfg, seed: int = 0) -> dict:
    """The reference's init as numpy arrays, each leaf moved by 0.1 × its
    spread (1 for a constant leaf) times a standard normal draw."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a.astype(jnp.float32))
        return (a + 0.1 * (a.std() or 1.0)
                * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree.map(move, RT.init_params(jax.random.PRNGKey(0), rcfg))


def _batch(cfg, seed: int = 1) -> dict:
    """Tokens and labels (B, S); a VLM's vision_embeds (B, Sv, D), an
    encoder-decoder's frames (B, encoder_context_len, D)."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    out = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1],
           "next": toks[:, S:]}
    if cfg.family == "vlm":
        out["vision_embeds"] = _draw(seed + 1, B, cfg.vision_prefix_len,
                                     cfg.d_model)
    else:
        out["frames"] = _draw(seed + 1, B, cfg.encoder_context_len,
                              cfg.d_model)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference config, reference params, port config, port
    params, host batch)."""
    arch = request.param
    rcfg, cfg = RC.reduced_config(arch), reduced_config(arch)
    tree = numpy_params(rcfg)
    return (arch, rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            T.lm_params_from_numpy(tree, device="cpu"), _batch(cfg))


def _split(batch, keys):
    sub = {k: batch[k] for k in keys if k in batch}
    return ({k: jnp.asarray(v) for k, v in sub.items()},
            {k: torch.from_numpy(v) for k, v in sub.items()})


def test_forward_and_loss_match_reference(pair):
    _, rcfg, rp, cfg, params, batch = pair
    jb, tb = _split(batch, ("tokens", "labels", "vision_embeds", "frames"))
    want, _ = RT.forward(rp, rcfg, jb, training=False)
    got, aux = T.forward(params, cfg, tb)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < RTOL
    ref_loss, _ = RT.loss_fn(rp, rcfg, jb)
    loss, metrics = T.loss_fn(params, cfg, tb)
    assert abs(float(loss) - float(ref_loss)) < RTOL * abs(float(ref_loss))
    assert float(metrics["aux"]) == 0.0


@pytest.fixture(scope="module")
def grads(pair):
    _, rcfg, rp, cfg, params, batch = pair
    jb, tb = _split(batch, ("tokens", "labels", "vision_embeds", "frames"))
    want = jax.grad(lambda p: RT.loss_fn(p, rcfg, jb)[0])(rp)
    loss, got = value_and_grad(
        lambda p, b: T.loss_fn(p, cfg, b)[0], params, tb)
    return cfg, params, tb, want, loss, got


def test_loss_gradients_match_jax_grad(grads):
    _, _, _, want, loss, got = grads
    assert torch.isfinite(loss)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = leaves_with_paths(got)
    assert [p for p, _ in got_leaves] == _paths(flat)
    for (path, g), (_, w) in zip(got_leaves, flat):
        assert _rel(g.numpy(), w) < RTOL, path


@pytest.mark.parametrize("remat", ["full", "dots", "outputs"])
def test_every_remat_gives_the_gradients_of_none(grads, remat):
    cfg, params, tb, _, loss, got = grads
    loss_r, got_r = value_and_grad(
        lambda p, b: T.loss_fn(p, cfg, b, remat=remat)[0], params, tb)
    assert float(loss_r) == float(loss)
    for (path, a), (_, b) in zip(leaves_with_paths(got_r),
                                 leaves_with_paths(got)):
        assert torch.equal(a, b), path


def test_prefill_matches_reference(pair):
    """A VLM's prefill (the vision prefix and the prompt: index Sv + S,
    caches grown by 4 slots) and three decode steps from its cache, every
    leaf; an encoder-decoder's prefill is its encoder's output and no
    cache, in both packages."""
    _, rcfg, rp, cfg, params, batch = pair
    jb, tb = _split(batch, ("tokens", "vision_embeds", "frames"))
    total = S + cfg.vision_prefix_len
    ref_out, ref_cache = RT.prefill(rp, rcfg, jb, pad_to=total + 4)
    out, cache = T.prefill(params, cfg, tb, pad_to=total + 4)
    if cfg.family == "audio":
        assert ref_cache is None and cache is None
        assert out.shape == (B, cfg.encoder_context_len, cfg.d_model)
        assert _rel(out.numpy(), ref_out) < RTOL
        return
    for step in range(4):
        assert _rel(out.numpy(), ref_out) < RTOL, step
        flat = jax.tree_util.tree_flatten_with_path(ref_cache)[0]
        got = leaves_with_paths(cache)
        assert [p for p, _ in got] == _paths(flat)
        for (path, leaf), (_, want) in zip(got, flat):
            assert tuple(leaf.shape) == want.shape, (step, path)
            if path == "['index']":
                assert int(leaf) == int(want) == total + step
            else:
                assert _rel(leaf.numpy(), want) < RTOL, (step, path)
        if step == 3:
            break
        tok = batch["next"][:, step:step + 1]
        ref_out, ref_cache = RT.decode_step(rp, rcfg, ref_cache,
                                            {"tokens": jnp.asarray(tok)})
        out, cache = T.decode_step(params, cfg, cache,
                                   {"tokens": torch.from_numpy(tok)})


def test_init_cache_layout_matches_reference(pair):
    """Leaf paths, shapes and dtypes of a zero cache (whisper's ``cross``
    of ``encoder_context_len`` frames among them), index 0."""
    _, rcfg, _, cfg, _, _ = pair
    want = RT.init_cache(rcfg, 3, 20)
    got = T.init_cache(cfg, 3, 20, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = leaves_with_paths(got)
    assert [p for p, _ in leaves] == _paths(flat)
    for (path, leaf), (_, ref_leaf) in zip(leaves, flat):
        assert tuple(leaf.shape) == ref_leaf.shape, path
        assert str(leaf.dtype).removeprefix("torch.") \
            == str(ref_leaf.dtype), path
        assert not leaf.any(), path


def test_input_specs_and_trainer_batches_match_reference(pair):
    """``input_specs`` at every kind (audio: seq frames and max(seq // 8,
    8) tokens; VLM: the prefix and seq - Sv tokens) and the trainer's
    ``to_model_batch`` against the reference's: the same keys, shapes and
    dtypes, the same values but a VLM's vision prefix (the reference's
    zeros; the port's the sinusoidal code of each patch position)."""
    arch, rcfg, _, cfg, _, _ = pair
    for kind in ("train", "prefill", "decode"):
        want = RR.input_specs(rcfg, RC.ShapeConfig("x", 40, 3, kind),
                              dryrun=False)
        got = registry.input_specs(cfg, 3, 40, kind)
        assert sorted(got) == sorted(want), (arch, kind)
        for k in got:
            assert got[k].shape == want[k].shape, (arch, kind, k)
            assert got[k].dtype == want[k].dtype, (arch, kind, k)
    host = {"tokens": np.ones((3, 12), np.int32),
            "labels": np.ones((3, 12), np.int32)}
    want = ref_train.to_model_batch(rcfg, host)
    got = train.to_model_batch(cfg, host, "cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") \
            == str(want[k].dtype), k
        if k == "vision_embeds":
            assert not np.asarray(want[k]).any()
            pos = L.sinusoidal_positions(torch.arange(cfg.vision_prefix_len),
                                         cfg.d_model)
            assert torch.equal(got[k], pos.expand(3, -1, -1))
        else:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_zero_vision_prefix_gives_the_reference_a_nan_gradient():
    """internvl2-1b's reduced widths at its full depth of 24 layers: the
    reference's trainer batch (a zero vision prefix) gives non-finite
    gradients in both packages (a zero row's RMS norms multiply its
    gradient by eps^-1/2 a layer until fp32 overflows); the port's
    trainer batch (sinusoidal patch codes) gives finite ones."""
    arch = "internvl2-1b"
    rcfg, cfg = (dataclasses.replace(c, n_layers=24) for c in (
        RC.reduced_config(arch), reduced_config(arch)))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        RT.init_params(jax.random.PRNGKey(0), rcfg))
    params = T.lm_params_from_numpy(tree, device="cpu")
    host = {"tokens": np.ones((2, 8), np.int32),
            "labels": np.ones((2, 8), np.int32)}
    ref_batch = ref_train.to_model_batch(rcfg, host)
    want = jax.grad(lambda p: RT.loss_fn(p, rcfg, ref_batch)[0])(
        jax.tree.map(jnp.asarray, tree))
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(want))

    def grads(batch):
        return value_and_grad(lambda p, b: T.loss_fn(p, cfg, b)[0], params,
                              batch)[1]

    zero = {k: torch.as_tensor(np.array(v)) for k, v in ref_batch.items()}
    assert not all(torch.isfinite(g).all()
                   for _, g in leaves_with_paths(grads(zero)))
    ours = train.to_model_batch(cfg, host, "cpu")
    assert all(torch.isfinite(g).all()
               for _, g in leaves_with_paths(grads(ours)))


def test_init_layout_matches_reference_at_full_width(pair, monkeypatch):
    """The port's own init at the arch's full widths cut to one layer (one
    encoder layer) and a vocab of 256, in bf16, on the meta device (shapes
    only): the reference's leaf paths, shapes and dtypes (norms and their
    biases fp32)."""
    arch = pair[0]
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.empty(
        shape, dtype=kw["dtype"], device="meta"))
    cut = dict(n_layers=1, vocab_size=256)
    if get_config(arch).encoder_decoder:
        cut["n_encoder_layers"] = 1
    rc, c = (dataclasses.replace(x, **cut)
             for x in (RC.get_config(arch), get_config(arch)))
    want = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rc))
    got = T.init_params(torch.Generator(), c, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in leaves_with_paths(got)] == _paths(flat)
    for (path, leaf), (_, ref_leaf) in zip(leaves_with_paths(got), flat):
        assert tuple(leaf.shape) == ref_leaf.shape, path
        assert str(leaf.dtype).removeprefix("torch.") \
            == str(ref_leaf.dtype), path


def _ref_cross(rp, rcfg, enc):
    """The reference's decode cache ``cross`` entry written from an
    encoder output by each layer's ``cross`` projections."""
    p = rp["blocks"]["pos0"]["cross"]
    n = p["k_proj"].shape[0]
    b, t, _ = enc.shape
    return {"pos0": {
        name: jnp.einsum("btd,nde->nbte", enc, p[w]).reshape(
            n, b, t, rcfg.n_kv_heads, rcfg.head_dim)
        for name, w in (("k", "k_proj"), ("v", "v_proj"))}}


def test_whisper_decode_against_the_encoder_output():
    """Prefill (the encoder), the cross cache written from its output,
    then four decode steps from index 0 in both packages: logits and every
    cache leaf against the reference's; and the port's steps equal its
    ``forward``'s first four positions."""
    arch = "whisper-small"
    rcfg, cfg = RC.reduced_config(arch), reduced_config(arch)
    tree = numpy_params(rcfg, seed=3)
    rp = jax.tree.map(jnp.asarray, tree)
    params = T.lm_params_from_numpy(tree, device="cpu")
    batch = _batch(cfg, seed=5)
    jb, tb = _split(batch, ("tokens", "frames"))
    ref_enc, _ = RT.prefill(rp, rcfg, {"frames": jb["frames"]})
    enc, _ = T.prefill(params, cfg, {"frames": tb["frames"]})
    ref_cache = dict(RT.init_cache(rcfg, B, 16),
                     cross=_ref_cross(rp, rcfg, ref_enc))
    cache = T.init_cache(cfg, B, 16, "cpu")
    cross = T.cross_cache(params, cfg, enc)
    for n in ("k", "v"):
        assert cross["pos0"][n].shape == cache["cross"]["pos0"][n].shape
        assert _rel(cross["pos0"][n].numpy(), ref_cache["cross"]["pos0"][n]) \
            < RTOL
    cache["cross"] = cross
    full, _ = T.forward(params, cfg, tb)
    for t in range(4):
        tok = batch["tokens"][:, t:t + 1]
        want, ref_cache = RT.decode_step(rp, rcfg, ref_cache,
                                         {"tokens": jnp.asarray(tok)})
        got, cache = T.decode_step(params, cfg, cache,
                                   {"tokens": torch.from_numpy(tok)})
        assert _rel(got.numpy(), want) < RTOL, t
        assert _rel(got[:, 0].numpy(), full[:, t].numpy()) < RTOL, t
        flat = jax.tree_util.tree_flatten_with_path(ref_cache)[0]
        for (path, leaf), (_, w) in zip(leaves_with_paths(cache), flat):
            if path != "['index']":
                assert _rel(leaf.numpy(), w) < RTOL, (t, path)
        assert int(cache["index"]) == t + 1


def test_vlm_jpeg_patch_embed_integration():
    """The reference's integration test on the port: the reduced internvl2
    tower fed patch embeddings from pixels (``unfold_patches_to_blocks @
    w``) and from block-DCT coefficients (``coefficient_patches``, the
    block_dct kernel's plain version here, through ``fold_patch_embed``)
    gives the same logits within the reference's 1e-3; and the port's
    logits on the coefficient embeddings equal the reference's on its own
    ``jpeg_encode`` coefficients within 1e-5."""
    arch = "internvl2-1b"
    rcfg, cfg = RC.reduced_config(arch), reduced_config(arch)
    tree = numpy_params(rcfg, seed=2)
    rp = jax.tree.map(jnp.asarray, tree)
    params = T.lm_params_from_numpy(tree, device="cpu")
    patch, channels = 16, 3
    side = int(np.sqrt(cfg.vision_prefix_len)) * patch
    imgs = _draw(4, 2, channels, side, side, scale=0.3)
    w = _draw(5, channels * patch * patch, cfg.d_model, scale=0.02)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    x, wt = torch.from_numpy(imgs), torch.from_numpy(w)
    pixel = tl.unfold_patches_to_blocks(x, patch) @ wt
    jpeg = tl.coefficient_patches(x, patch, 50) @ tl.fold_patch_embed(
        wt, patch, channels, quality=50, scaled=True)
    model = registry.build_model(cfg)
    tt = torch.from_numpy(toks)
    out_px, _ = model.forward(params, {"tokens": tt, "vision_embeds": pixel})
    out_jp, _ = model.forward(params, {"tokens": tt, "vision_embeds": jpeg})
    assert np.abs((out_px - out_jp).numpy()).max() < 1e-3

    coef = ref_jpeg.jpeg_encode(jnp.asarray(imgs), scaled=True)
    g, pb = side // patch, patch // 8
    cc = coef.reshape(2, channels, g, pb, g, pb, 64)
    cc = jnp.moveaxis(jnp.moveaxis(cc, 4, 3), 1, 3)
    flat = cc.reshape(2, g * g, channels * pb * pb * 64)
    ref_embeds = flat @ ref_tl.fold_patch_embed(jnp.asarray(w), patch,
                                                channels, scaled=True)
    assert _rel(jpeg.numpy(), ref_embeds) < 1e-4
    want, _ = RT.forward(rp, rcfg, {"tokens": jnp.asarray(toks),
                                    "vision_embeds": ref_embeds},
                         training=False)
    got, _ = model.forward(params, {"tokens": tt, "vision_embeds":
                                    torch.from_numpy(np.array(
                                        ref_embeds))})
    assert _rel(got.numpy(), want) < RTOL


@pytest.mark.parametrize("arch", ["rwkv6-7b", "internvl2-1b",
                                  "whisper-small"])
def test_serve_lm_reports_what_the_reference_reports(arch, capsys):
    """Decode-only serving from ``init_cache`` (whisper against its zero
    cross cache, as the reference's): the same request budgets, tokens
    and completions."""
    argv = ["--arch", arch, "--reduced", "--batch", "3", "--requests", "5",
            "--max-new", "6", "--seed", "2", "--ctx", "32"]
    got = serve.serve_lm(serve.parse_args(argv + ["--device", "cpu"]))
    want = ref_serve.serve_lm(type("Args", (), dict(
        vars(serve.parse_args(argv)), device=None)))
    assert sorted(got) == sorted(want)
    assert got["decode_tokens"] == want["decode_tokens"]
    assert got["completed"] == want["completed"] == 5
    assert got["arch"] == want["arch"]
    assert '"decode_tokens"' in capsys.readouterr().out
