"""Parity of the PyTorch port's training path with the JAX package.

The JAX parameter tree of a tiny fp32 model goes through ``params_from_jax``
so both packages compute the same function; tokens come from numpy with a
seed. The JAX side runs ``train_forward`` (its Pallas forward and backward
kernels in interpret mode on the CPU) under ``jax.value_and_grad``; the port
runs its ``train_forward`` under autograd, whose attention goes through the
port's autograd Function with the plain forward and backward for CPU
tensors (the card runs K1 and K3, or K1, K4 and K5, in the same wiring).

Tolerances: attention output and logits 1e-4 absolute (fp32, the same math
summed in another order); the loss 1e-5; each leaf's gradient within 1e-4
of its largest JAX value, plus 1e-6 absolute for leaves whose gradient is
near 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flash_attention_tpu.models import attention as jax_attention
from flash_attention_tpu.models import transformer as jt
from flash_attention_tpu_torch.models import attention as tattn
from flash_attention_tpu_torch.models import transformer as tt
from flash_attention_tpu_torch.models.convert import params_from_jax

OUT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_REL_TOL = 1e-4
GRAD_ABS_TOL = 1e-6
CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)
# num_kv_heads: 2 is GQA (K4 + K5 on the card), 4 is MHA (K3).
ROUTES = [pytest.param(2, id="gqa-K4K5"), pytest.param(4, id="mha-K3")]


def _model(kv_heads: int, seed: int = 0):
    cfg = {**CFG, "num_kv_heads": kv_heads}
    jcfg, tcfg = jt.ModelConfig(**cfg), tt.ModelConfig(**cfg)
    jparams = jt.init_model_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _diff(got: torch.Tensor, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max())


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], shape).astype(np.int32)


def _jax_loss(jcfg, tokens):
    def loss(params):
        logits = jt.train_forward(params, jcfg, jnp.asarray(tokens[:, :-1]))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(tokens[:, 1:])[..., None], axis=-1))

    return loss


def _torch_loss(params, tcfg, tokens):
    t = torch.from_numpy(tokens).long()
    logits = tt.train_forward(params, tcfg, t[:, :-1])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), t[:, 1:].reshape(-1))


@pytest.mark.parametrize("kv_heads", ROUTES)
@pytest.mark.parametrize("t", [37, 64])
def test_attention_forward_matches_jax(kv_heads, t):
    jcfg, tcfg, jparams, tparams = _model(kv_heads)
    acfg_j, acfg_t = jcfg.attention_config(), tcfg.attention_config()
    x = np.random.default_rng(1).normal(size=(2, t, CFG["model_dim"])).astype(np.float32)
    lp_j, lp_t = jparams["layers"][0]["attn"], tparams["layers"][0]["attn"]
    want = jax_attention.attention_forward(lp_j, acfg_j, jnp.asarray(x))
    got = tattn.attention_forward(lp_t, acfg_t, torch.from_numpy(x))
    assert _diff(got, want) <= OUT_TOL
    # Explicit positions (a packed batch's restarts) rotate the same way.
    pos = np.concatenate([np.arange(t // 2), np.arange(t - t // 2)]).astype(np.int32)[None].repeat(2, 0)
    want = jax_attention.attention_forward(lp_j, acfg_j, jnp.asarray(x), positions=jnp.asarray(pos))
    got = tattn.attention_forward(lp_t, acfg_t, torch.from_numpy(x), positions=torch.from_numpy(pos))
    assert _diff(got, want) <= OUT_TOL


@pytest.mark.parametrize("kv_heads", ROUTES)
def test_train_forward_logits_match_jax(kv_heads):
    jcfg, tcfg, jparams, tparams = _model(kv_heads)
    tokens = _tokens(2, (2, 45))
    want = jt.train_forward(jparams, jcfg, jnp.asarray(tokens))
    got = tt.train_forward(tparams, tcfg, torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == (2, 45, CFG["vocab_size"])
    assert _diff(got, want) <= OUT_TOL


@pytest.mark.parametrize("kv_heads", ROUTES)
@pytest.mark.parametrize("t", [33, 70])
def test_loss_and_every_gradient_match_jax(kv_heads, t):
    """jax.value_and_grad of the next-token loss against autograd through
    the port, leaf by leaf over the whole tree (embedding, norms, wq/wk/wv/wo,
    the MLP): every leaf gets a gradient, attention's projections included."""
    jcfg, tcfg, jparams, tparams = _model(kv_heads, seed=3)
    tokens = _tokens(4 + t, (2, t + 1))
    want_loss, want_grads = jax.value_and_grad(_jax_loss(jcfg, tokens))(jparams)
    leaves = jax.tree.leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_()
    loss = _torch_loss(tparams, tcfg, tokens)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_TOL
    want_leaves, want_tree = jax.tree.flatten(want_grads)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, tparams)) == want_tree
    assert len(grads) == len(want_leaves)
    for i, (g, w) in enumerate(zip(grads, want_leaves)):
        scale = float(np.abs(np.asarray(w)).max())
        assert scale > 0, f"leaf {i}: JAX gives it no gradient"
        assert _diff(g, w) <= GRAD_REL_TOL * scale + GRAD_ABS_TOL, f"leaf {i} {tuple(g.shape)}"


def test_segment_ids_raise_naming_the_roadmap_item():
    """A batch that is one document gives the unpacked logits and attention
    output, and two documents give others."""
    jcfg, tcfg, _, tparams = _model(2)
    tokens = torch.from_numpy(_tokens(5, (1, 16))).long()
    one_doc = torch.zeros((1, 16), dtype=torch.int32)
    two_docs = torch.tensor([[0] * 9 + [1] * 7], dtype=torch.int32)
    plain = tt.train_forward(tparams, tcfg, tokens)
    assert _diff(tt.train_forward(tparams, tcfg, tokens, segment_ids=one_doc), plain.detach()) <= OUT_TOL
    assert _diff(tt.train_forward(tparams, tcfg, tokens, segment_ids=two_docs), plain.detach()) > OUT_TOL
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 16, CFG["model_dim"])).astype(np.float32))
    lp, acfg = tparams["layers"][0]["attn"], tcfg.attention_config()
    want = tattn.attention_forward(lp, acfg, x).detach()
    assert _diff(tattn.attention_forward(lp, acfg, x, segment_ids=one_doc), want) <= OUT_TOL
