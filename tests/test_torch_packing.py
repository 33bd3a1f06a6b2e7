"""Port parity: configs and the packed-word layout are identical to the
JAX package's, bit for bit; the port imports nothing of JAX, and its
smoke script refuses to run without a card."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core import packing as jp
from repro_torch import configs as pt_configs
from repro_torch.core import packing as tp

ROOT = Path(__file__).resolve().parent.parent
# one compile per (width, block) instead of one per eager op
jax_pack_blocked = jax.jit(jp.pack_blocked, static_argnums=(1, 2, 3))
WIDTHS = list(range(1, 9)) + [16]
BLOCKS = [32, 64, 128, 256, 512]


def test_configs_match_reference_field_for_field():
    assert sorted(pt_configs.ARCHS) == sorted(jax_configs.ARCHS)
    for name, ref in jax_configs.ARCHS.items():
        port = pt_configs.get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
        assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
        assert port.param_count() == ref.param_count()


def _codes(rng, k, K, N=8):
    lo, hi = -(2 ** (k - 1)), 2 ** (k - 1) - 1
    return rng.integers(lo, hi + 1, size=(K, N)).astype(np.int32)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("k", WIDTHS)
def test_pack_blocked_words_bit_identical(k, block):
    rng = np.random.default_rng(100 * k + block)
    K = 2 * block + block // 2                        # ragged last block
    codes = _codes(rng, k, K)
    wj = np.asarray(jax_pack_blocked(jnp.asarray(codes), k, block, axis=0))
    wt = tp.pack_blocked(torch.from_numpy(codes), k, block, axis=0)
    assert wt.dtype == torch.int32
    np.testing.assert_array_equal(wt.numpy(), wj)
    assert tp.blocked_rows(block, k) == jp.blocked_rows(block, k)
    back = tp.unpack_blocked(wt, k, K, block, axis=0)
    np.testing.assert_array_equal(back.numpy(), codes)
    # a packing axis other than 0 (the stacked-leaf case)
    stacked = np.stack([codes, codes[::-1]])
    np.testing.assert_array_equal(
        tp.pack_blocked(torch.from_numpy(stacked), k, block, axis=1).numpy(),
        np.asarray(jax_pack_blocked(jnp.asarray(stacked), k, block, axis=1)))


def test_one_bit_words_set_the_sign_bit():
    """32 one-bit slots per word: a code of -1 in the last slot sets bit 31,
    which the port must build in int64 and wrap to a negative int32."""
    codes = -np.ones((64, 4), np.int32)
    wt = tp.pack_blocked(torch.from_numpy(codes), 1, 64)
    wj = np.asarray(jax_pack_blocked(jnp.asarray(codes), 1, 64))
    np.testing.assert_array_equal(wt.numpy(), wj)
    assert (wt == -1).all()
    np.testing.assert_array_equal(tp.unpack_blocked(wt, 1, 64, 64).numpy(), codes)


@pytest.mark.parametrize("k", WIDTHS)
def test_unpack_block_words_matches_reference(k):
    rng = np.random.default_rng(k)
    block = 128
    words = rng.integers(-2 ** 31, 2 ** 31, size=(tp.blocked_rows(block, k), 16),
                         dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        tp.unpack_block_words(torch.from_numpy(words), k, block).numpy(),
        np.asarray(jp.unpack_block_words(jnp.asarray(words), k, block)))


@pytest.mark.parametrize("k,block", [(3, 64), (4, 128), (7, 512), (8, 256), (16, 32)])
def test_gather_block_rows_matches_reference(k, block):
    rng = np.random.default_rng(7 * k)
    K = 4 * block
    codes = _codes(rng, k, K, N=24)
    words = np.asarray(jax_pack_blocked(jnp.asarray(codes), k, block))
    idx = rng.integers(0, K, size=37)
    got = tp.gather_block_rows(torch.from_numpy(words), k, block, torch.from_numpy(idx))
    ref = jp.gather_block_rows(jnp.asarray(words), k, block, jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), codes[idx])


@pytest.mark.parametrize("K", [64, 96, 100, 1536, 8960, 151936])
def test_choose_block_matches_reference(K):
    assert tp.choose_block(K) == jp.choose_block(K)


def test_convert_defaults_to_the_entry_points_device(monkeypatch):
    """Converted trees land where every entry point defaults to (the card),
    not on the CPU; "meta" stands in for the card here."""
    from repro_torch import convert
    from repro_torch import device as port_device
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "meta")
    words = _codes(np.random.default_rng(0), 8, 4)
    tree = {"w": convert.NestedArrays(w_base=words, deltas=(None,),
                                      scale=np.ones((1, 8), np.float32), shape=(4, 8),
                                      bits=(4, 8), block=4, rung=0),
            "b": convert.Bf16Array(np.zeros(8, np.uint16)), "n": np.zeros(3, np.float32)}
    out = convert.params_from_numpy(tree)
    assert {out["w"].w_base.device.type, out["w"].scale.device.type,
            out["b"].device.type, out["n"].device.type} == {"meta"}
    assert out["b"].dtype == torch.bfloat16
    assert convert.tensor_from_numpy(words).device.type == "meta"
    assert convert.tensor_from_numpy(words, "cpu").device.type == "cpu"


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    for f in files:
        hits = bad.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout and '"kernels"' not in run.stdout
