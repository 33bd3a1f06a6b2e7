"""Port parity of the serving path: ServeEngine.generate over a budget
schedule that walks rungs 2 -> 0 -> 1 -> 2 gives the JAX engine's tokens,
and the store's ledger events equal the JAX store's byte for byte."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.switching import NestQuantStore
from repro_torch.serving import Request, ServeEngine
from torch_parity import jax_tree_to_torch, reduced_qwen2

jsw = importlib.import_module("repro.core.switching")

SCHEDULE = (2, 0, 1, 2)
PROMPT_LENS = (5, 8, 6)


def _budget(store, rung):
    """A budget that admits exactly ``rung`` (the launch/serve.py rule)."""
    need = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
    return need[-1] * 2 if rung == store.num_rungs - 1 else need[rung]


def _prompts(phase, vocab):
    rng = np.random.default_rng(10 + phase)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def engines():
    jcfg, _, nested = reduced_qwen2()
    jstore = jsw.NestQuantStore(nested, mode="part", dtype=jnp.float32)
    pstore = NestQuantStore(jax_tree_to_torch(nested), mode="part", device="cpu")
    cfg = get_config("qwen2-1.5b").reduced()
    return (JaxEngine(jcfg, jstore, max_batch=4, max_len=24),
            ServeEngine(cfg, pstore, max_batch=4, max_len=24))


def test_generate_walks_rungs_token_identical_with_exact_ledger(engines):
    jeng, peng = engines
    for phase, rung in enumerate(SCHEDULE):
        prompts = _prompts(phase, peng.cfg.vocab_size)
        jreqs = [JaxRequest(i, p, max_new_tokens=4) for i, p in enumerate(prompts)]
        preqs = [Request(i, p, max_new_tokens=4) for i, p in enumerate(prompts)]
        jeng.generate(jreqs, memory_budget_bytes=_budget(jeng.store, rung))
        peng.generate(preqs, memory_budget_bytes=_budget(peng.store, rung))
        assert peng.store.rung == jeng.store.rung == rung
        assert [r.out_tokens for r in preqs] == [r.out_tokens for r in jreqs], phase
    assert peng.store.ledger.events == jeng.store.ledger.events
    assert peng.store.ledger.switches == jeng.store.ledger.switches == 6
    assert (peng.stats.switches, peng.stats.prefills, peng.stats.decode_steps) == \
        (jeng.stats.switches, jeng.stats.prefills, jeng.stats.decode_steps)
    assert list(peng.stats.mode_history) == list(jeng.stats.mode_history)


def test_engine_refuses_what_is_not_ported(engines):
    _, peng = engines
    from repro_torch.models.model import make_model
    # every family builds now; a state-space family has no chunked verify
    # pass, so speculation is refused, as the JAX package refuses it
    ssm = ServeEngine(get_config("mamba2-780m").reduced(), peng.store,
                      model=make_model(get_config("mamba2-780m").reduced(), device="cpu"))
    with pytest.raises(NotImplementedError, match="needs a chunked verify pass"):
        ssm.generate([Request(0, np.zeros(4, np.int32))], speculate=2)
    with pytest.raises(TypeError, match="KVCacheConfig or a NestedKVCache"):
        ServeEngine(peng.cfg, peng.store, kv=object())
    with pytest.raises(ValueError):
        peng.generate([Request(i, np.zeros(3, np.int32)) for i in range(5)])
