"""Port parity of AdamW (``repro_torch/optim/adamw.py``): the schedule bit
for bit, the global norm and clipping, and three AdamW steps fed the same
gradients - f32 and bf16 parameters, matrices (decayed) and vectors (not) -
with state and parameters within 1e-6 relative and ``lr`` exact.

The global norm is a sum of squares over every gradient element.  The
reference's XLA CPU reduction adds them in sequence in f32 (relative error
up to n * 2^-24 for n terms: 3e-6 on these 1.4 k elements), the port's
pairwise, within 1e-6 of the float64 sum.  On the step whose gradients are
clipped every gradient is scaled by 1 / norm, so there the comparison
allows, beyond 1e-6, the two norms' measured relative difference (twice
it for v, which is quadratic in the gradient); unclipped steps take scale
1 in both packages and are held to 1e-6 alone."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.optim import adamw
from torch_parity import j2n, t2n, to_torch

REL = 1e-6


def _close(port, ref, rel=REL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(port - ref).max() <= rel * scale, (np.abs(port - ref).max(), scale)


@pytest.mark.parametrize("peak,warmup,total", [(3e-3, 20, 200), (1e-3, 8, 24), (0.5, 0, 7)])
def test_warmup_cosine_is_bit_exact(peak, warmup, total):
    for step in range(total + 3):
        want = np.asarray(jadamw.warmup_cosine(jnp.asarray(step), peak_lr=peak,
                                               warmup=warmup, total=total))
        got = adamw.warmup_cosine(step, peak_lr=peak, warmup=warmup, total=total)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.astype(np.float32).tobytes(), step


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"w": (3, 16, 24), "b": (3, 24)}, "lm_head": {"w": (16, 40)},
              "norm": {"scale": (16,)}}
    return {k: ({n: rng.normal(size=s).astype(np.float32) for n, s in v.items()})
            for k, v in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_adamw_steps_match_the_reference(dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params_np = _trees(0)
    jparams = {k: {n: jnp.asarray(a, jdt) for n, a in v.items()} for k, v in params_np.items()}
    # the norm scale stays f32, as the models keep it
    jparams["norm"]["scale"] = jnp.asarray(params_np["norm"]["scale"])
    tparams = {k: {n: to_torch(a) for n, a in v.items()} for k, v in jparams.items()}
    jst, tst = jadamw.init_state(jparams), adamw.init_state(tparams)
    for step in range(3):
        grads_np = _trees(10 + step)
        # step 2 is clipped hard (global norm far above 1), the others not
        mult = 50.0 if step == 2 else 0.01
        jgrads = {k: {n: jnp.asarray(a * mult, jparams[k][n].dtype) for n, a in v.items()}
                  for k, v in grads_np.items()}
        tgrads = {k: {n: to_torch(a) for n, a in v.items()} for k, v in jgrads.items()}
        jlr = jadamw.warmup_cosine(jnp.asarray(step), peak_lr=1e-2, warmup=2, total=3)
        tlr = adamw.warmup_cosine(step, peak_lr=1e-2, warmup=2, total=3)
        jparams, jst, jm = jadamw.apply_update(jparams, jgrads, jst, lr=jlr)
        tparams, tst, tm = adamw.apply_update(tparams, tgrads, tst, lr=tlr)
        assert tm["lr"].numpy().tobytes() == np.asarray(jm["lr"]).tobytes()
        exact = np.sqrt(sum((t2n(g).astype(np.float64) ** 2).sum()
                            for g in tree.leaves(tgrads)))
        _close(t2n(tm["grad_norm"]), exact)
        gn_rel = abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) / exact
        clipped = exact > 1.0
        assert clipped == (step == 2)
        assert int(tst.step) == int(jst.step) == step + 1
        for part, k in (("m", 1), ("v", 2), ("master", 1)):
            for (key, a), b in zip(tree.flatten_with_path(getattr(tst, part)),
                                   tree.leaves(getattr(jst, part))):
                assert a.dtype == torch.float32, key
                _close(t2n(a), j2n(b), REL + (k * gn_rel if clipped else 0.0))
        for (key, a), b in zip(tree.flatten_with_path(tparams), tree.leaves(jparams)):
            assert t2n(a).dtype == j2n(b).dtype and a.shape == b.shape, key
            _close(t2n(a), j2n(b), REL if a.dtype == torch.float32 else 2 ** -8)


def test_clip_by_global_norm_matches_the_reference():
    g = _trees(3)
    jg = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in g.items()}
    tg = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in g.items()}
    for max_norm in (0.5, 1e6):
        jc, jn = jadamw.clip_by_global_norm(jg, max_norm)
        tc, tn = adamw.clip_by_global_norm(tg, max_norm)
        _close(t2n(tn), j2n(jn))
        for a, b in zip(tree.leaves(tc), tree.leaves(jc)):
            assert a.dtype == torch.float32
            _close(t2n(a), j2n(b))
    assert float(adamw.global_norm(tg)) == pytest.approx(float(jadamw.global_norm(jg)), rel=1e-6)
