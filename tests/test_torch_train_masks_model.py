"""Parity of the port's masked training path with the JAX package.

A tiny fp32 model with a sliding window, a logit softcap and packed-sequence
segment ids: ``segment_positions``, ``attention_forward`` and
``train_forward`` against the JAX package's (its Pallas kernels in
interpret mode on the CPU), the loss and every leaf's gradient against
``jax.value_and_grad``. The JAX parameter tree goes through
``params_from_jax`` so both packages compute the same function; tokens and
inputs come from numpy with a seed.

Tolerances as tests/test_torch_train.py's: outputs and logits 1e-4, the loss
1e-5, each leaf's gradient within 1e-4 of its largest JAX value plus 1e-6.
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
MASKS = dict(sliding_window=24, logit_softcap=30.0)
# num_kv_heads: 2 is GQA (K1d, K4 + K5 on the card), 4 is MHA (K1d, K3).
ROUTES = [pytest.param(2, id="gqa-K4K5"), pytest.param(4, id="mha-K3")]


def _model(kv_heads: int, seed: int = 0, **masks):
    cfg = {**CFG, "num_kv_heads": kv_heads, **masks}
    jcfg, tcfg = jt.ModelConfig(**cfg), tt.ModelConfig(**cfg)
    jparams = jt.init_model_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _segments(batch_docs) -> np.ndarray:
    """Segment ids [B, T] int32, row b holding documents of the lengths in
    batch_docs[b] (ids 0, 1, ... in order)."""
    return np.stack([np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(docs)]) for docs in batch_docs])


def _diff(got: torch.Tensor, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max())


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize(
    "ids",
    [
        [[0] * 6 + [1] * 4],
        [[3, 3, 3, 7, 7, 2, 2, 2, 2, 9], [1] * 10],
        [[0, 1, 2, 3, 4, 5, 6, 7, 8, 9]],
        [[5, 5, 6, 6, 5, 5, 5, 6, 6, 6]],
    ],
)
def test_segment_positions_match_jax(ids):
    ids = np.asarray(ids, np.int32)
    want = np.asarray(jt.segment_positions(jnp.asarray(ids)))
    got = tt.segment_positions(torch.from_numpy(ids))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv_heads", ROUTES)
@pytest.mark.parametrize(
    "masks,docs",
    [
        pytest.param(MASKS, None, id="window-softcap"),
        pytest.param({}, [[30, 20, 14], [64]], id="segments"),
        pytest.param(MASKS, [[30, 20, 14], [10, 54]], id="all-three"),
    ],
)
def test_masked_attention_forward_matches_jax(kv_heads, masks, docs):
    jcfg, tcfg, jparams, tparams = _model(kv_heads, **masks)
    x = np.random.default_rng(1).normal(size=(2, 64, CFG["model_dim"])).astype(np.float32)
    ids = None if docs is None else _segments(docs)
    pos = None if ids is None else np.array(jt.segment_positions(jnp.asarray(ids)))
    lp_j, lp_t = jparams["layers"][0]["attn"], tparams["layers"][0]["attn"]
    want = jax_attention.attention_forward(
        lp_j, jcfg.attention_config(), jnp.asarray(x),
        positions=None if pos is None else jnp.asarray(pos), segment_ids=None if ids is None else jnp.asarray(ids),
    )
    got = tattn.attention_forward(
        lp_t, tcfg.attention_config(), torch.from_numpy(x),
        positions=None if pos is None else torch.from_numpy(pos),
        segment_ids=None if ids is None else torch.from_numpy(ids),
    )
    assert _diff(got, want) <= OUT_TOL


def test_packed_train_forward_equals_documents_one_by_one():
    """tests/test_segments.py:134: a packed row's logits equal each document
    run alone (per-document RoPE positions and the segment mask), with the
    window and the softcap."""
    _, tcfg, _, tparams = _model(2, **MASKS)
    docs = [_tokens(7, (1, 30)), _tokens(8, (1, 9)), _tokens(9, (1, 25))]
    packed = torch.from_numpy(np.concatenate(docs, axis=1)).long()
    ids = torch.from_numpy(_segments([[30, 9, 25]]))
    logits = tt.train_forward(tparams, tcfg, packed, segment_ids=ids)
    start = 0
    for doc in docs:
        alone = tt.train_forward(tparams, tcfg, torch.from_numpy(doc).long())
        assert _diff(logits[:, start:start + doc.shape[1]], alone.detach().numpy()) <= OUT_TOL
        start += doc.shape[1]


def _jax_loss(jcfg, tokens, ids):
    def loss(params):
        logits = jt.train_forward(params, jcfg, jnp.asarray(tokens[:, :-1]),
                                  segment_ids=None if ids is None else jnp.asarray(ids))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(tokens[:, 1:])[..., None], axis=-1))

    return loss


def _torch_loss(params, tcfg, tokens, ids):
    t = torch.from_numpy(tokens).long()
    logits = tt.train_forward(params, tcfg, t[:, :-1], segment_ids=None if ids is None else torch.from_numpy(ids))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), t[:, 1:].reshape(-1))


@pytest.mark.parametrize("kv_heads", ROUTES)
@pytest.mark.parametrize(
    "masks,docs",
    [
        pytest.param(MASKS, [[20, 25, 15], [60]], id="window-softcap-segments"),
        pytest.param({"sliding_window": 100}, [[33, 27], [5, 55]], id="window-past-the-documents"),
    ],
)
def test_masked_loss_and_every_gradient_match_jax(kv_heads, masks, docs):
    """jax.value_and_grad of the next-token loss of a packed batch under a
    window and a softcap, against autograd through the port, leaf by leaf."""
    jcfg, tcfg, jparams, tparams = _model(kv_heads, seed=3, **masks)
    ids = _segments(docs)
    tokens = _tokens(11, (2, ids.shape[1] + 1))
    want_loss, want_grads = jax.value_and_grad(_jax_loss(jcfg, tokens, ids))(jparams)
    leaves = jax.tree.leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_()
    loss = _torch_loss(tparams, tcfg, tokens, ids)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_TOL
    want_leaves, want_tree = jax.tree.flatten(want_grads)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, tparams)) == want_tree
    for i, (g, w) in enumerate(zip(grads, want_leaves)):
        scale = float(np.abs(np.asarray(w)).max())
        assert scale > 0, f"leaf {i}: JAX gives it no gradient"
        assert _diff(g, w) <= GRAD_REL_TOL * scale + GRAD_ABS_TOL, f"leaf {i} {tuple(g.shape)}"
