"""Port parity of the storage tier: the port's artifact format is the JAX
package's byte for byte (segment SHA-256s and manifests), each package
opens the other's artifacts, a cold boot reads only the manifest and the
base, progressive delivery ledgers exactly bytes(delta_k) per poll,
corruption raises ``CorruptStreamError`` (also an ``ArtifactError``), and
the simulated link's timings equal the JAX package's."""
import hashlib
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.recipe import QuantRecipe as JaxRecipe
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxEngine
from repro.storage import FilePager as JaxFilePager
from repro.storage import LinkBudget as JaxLinkBudget
from repro.storage import ThrottledPager as JaxThrottled
from repro.storage import VirtualClock as JaxClock
from repro.storage import open_artifact as jax_open
from repro.storage import save_artifact as jax_save
from repro_torch.configs import get_config
from repro_torch.core.recipe import QuantRecipe
from repro_torch.core.switching import NestQuantStore
from repro_torch.serving import Request, ServeEngine
from repro_torch.storage import (ArtifactError, CorruptStreamError, FilePager,
                                 InMemoryPager, LinkBudget, ThrottledPager,
                                 VirtualClock, load_store, open_artifact,
                                 save_artifact)
from torch_parity import jax_tree_to_torch, reduced_qwen2, t2n

RECIPE = dict(bits=(8, 6, 4), rounding="rtn")


@pytest.fixture(scope="module")
def trees():
    jcfg, _, nested = reduced_qwen2()
    return jcfg, nested, jax_tree_to_torch(nested)


@pytest.fixture(scope="module")
def ref_dir(trees, tmp_path_factory):
    """The JAX package's artifact of the reduced qwen2 (8, 6, 4) tree."""
    path = str(tmp_path_factory.mktemp("ref") / "artifact")
    jax_save(trees[1], path, recipe=JaxRecipe(**RECIPE))
    return path


@pytest.fixture(scope="module")
def port_dir(trees, tmp_path_factory):
    """The port's artifact of the same tree."""
    path = str(tmp_path_factory.mktemp("port") / "artifact")
    save_artifact(trees[2], path, recipe=QuantRecipe(**RECIPE))
    return path


def _stage(src, dst, files=("manifest.json", "base.seg")):
    os.makedirs(dst)
    for f in files:
        shutil.copy(os.path.join(src, f), dst)
    return dst


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_port_writes_the_reference_format_byte_for_byte(ref_dir, port_dir):
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    with open(os.path.join(ref_dir, "manifest.json")) as f:
        ref_manifest = json.load(f)
    with open(os.path.join(port_dir, "manifest.json")) as f:
        port_manifest = json.load(f)
    assert port_manifest == ref_manifest
    for name, seg in ref_manifest["segments"].items():
        assert _sha(os.path.join(port_dir, seg["file"])) == seg["sha256"], name
    assert _sha(os.path.join(port_dir, "manifest.json")) == \
        _sha(os.path.join(ref_dir, "manifest.json"))
    assert open_artifact(port_dir).recipe() == QuantRecipe(**RECIPE)


def test_port_artifact_opens_in_the_reference_bit_for_bit(trees, port_dir):
    _, nested, _ = trees
    art = jax_open(port_dir)
    art.verify()
    base = art.load_base_tree()
    pager = JaxFilePager(art)
    for key in ("blocks", "embed", "final_norm", "lm_head"):
        want, got = nested[key], base[key]
        for (wk, w), (gk, g) in zip(_leaves(want), _leaves(got)):
            assert wk == gk
            if hasattr(w, "w_base"):
                np.testing.assert_array_equal(np.asarray(g.w_base), np.asarray(w.w_base))
                np.testing.assert_array_equal(np.asarray(g.scale), np.asarray(w.scale))
                assert all(d is None for d in g.deltas)
            else:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for path, entry in art._by_path.items():
        for lvl in range(len(entry["arrays"].get("deltas", ()))):
            leaf = _at(nested, entry["elems"])
            np.testing.assert_array_equal(np.asarray(pager.fetch(path, lvl)),
                                          np.asarray(leaf.deltas[lvl]))


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        return [kv for k in sorted(node) for kv in _leaves(node[k], f"{prefix}/{k}")]
    return [(prefix, node)]


def _at(tree, elems):
    for e in elems:
        tree = tree[e["k"]]
    return tree


def _budget(store, rung):
    need = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
    return need[-1] * 2 if rung == store.num_rungs - 1 else need[rung]


def test_reference_artifact_serves_reference_tokens_in_the_port(trees, ref_dir):
    """Booted from the JAX package's artifact, the port serves the JAX
    engine's greedy tokens at rungs 0, 1 and 2, with the same ledger."""
    jcfg = trees[0]
    cfg = get_config("qwen2-1.5b").reduced()
    jeng = JaxEngine.from_artifact(jcfg, ref_dir, max_batch=3, max_len=16,
                                   dtype=jnp.float32)
    peng = ServeEngine.from_artifact(cfg, ref_dir, max_batch=3, max_len=16,
                                     device="cpu")
    assert peng.store.rung == 0 and peng.artifact.segments_read == {"base"}
    for rung in (0, 1, 2):
        rng = np.random.default_rng(40 + rung)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in (6, 4, 5)]
        jreqs = [JaxRequest(i, p, max_new_tokens=3) for i, p in enumerate(prompts)]
        preqs = [Request(i, p, max_new_tokens=3) for i, p in enumerate(prompts)]
        jeng.generate(jreqs, memory_budget_bytes=_budget(jeng.store, rung))
        peng.generate(preqs, memory_budget_bytes=_budget(peng.store, rung))
        assert peng.store.rung == jeng.store.rung == rung
        assert [r.out_tokens for r in preqs] == [r.out_tokens for r in jreqs], rung
    assert peng.store.ledger.events == jeng.store.ledger.events
    assert peng.artifact.bytes_read == jeng.artifact.bytes_read


def test_cold_boot_reads_only_the_manifest_and_the_base(ref_dir, tmp_path):
    stage = _stage(ref_dir, str(tmp_path / "stage"))
    eng = ServeEngine.from_artifact(get_config("qwen2-1.5b").reduced(), stage,
                                    max_batch=2, max_len=16, device="cpu")
    art = eng.artifact
    assert art.segments_read == {"base"}
    assert set(art.bytes_read) == {"manifest", "base"}
    assert art.bytes_read["base"] == art.segment_nbytes("base")
    assert eng.store.rung == 0 and eng.store.max_available_rung() == 0
    assert eng.poll_delivery() == {"from_rung": 0, "rung": 0, "modes": [],
                                   "page_in": 0, "failed": ""}
    out = eng.generate([Request(0, np.arange(5, dtype=np.int32), max_new_tokens=2)])
    assert len(out[0].out_tokens) == 2


def test_progressive_delivery_ledgers_each_delta_segment(ref_dir, tmp_path):
    """Segments arrive one by one; each poll climbs one rung and pages
    exactly bytes(delta_k), the segment's own size; a throttled link moves
    the same bytes and charges the same simulated time as the JAX one."""
    stage = _stage(ref_dir, str(tmp_path / "stage"))
    clock, jclock = VirtualClock(), JaxClock()
    pager = ThrottledPager(FilePager(stage, device="cpu"), clock=clock, sleep=True)
    eng = ServeEngine.from_artifact(get_config("qwen2-1.5b").reduced(), stage,
                                    pager=pager, max_batch=2, max_len=16, device="cpu")
    jpager = JaxThrottled(JaxFilePager(stage), clock=jclock, sleep=True)
    art, store = eng.artifact, eng.store
    for k in range(store.num_rungs - 1):
        shutil.copy(os.path.join(ref_dir, f"delta_{k}.seg"), stage)
        rep = eng.poll_delivery()
        assert rep["modes"] == [f"rung{k + 1}" if k + 1 < 2 else "full"]
        assert rep["page_in"] == store.delta_bytes(k) == art.segment_nbytes(f"delta_{k}")
        for path, _ in store.nested_leaves():
            jpager.fetch(path, k)
    assert [e[:2] for e in store.ledger.events] == [(0, 1), (1, 2)]
    assert pager.bytes_moved == store.ledger.page_in_bytes == jpager.bytes_moved
    assert pager.transfers == jpager.transfers
    assert pager.simulated_seconds == jpager.simulated_seconds
    assert clock.now() == jclock.now() == pager.simulated_seconds
    assert pager.inner.resident_bytes() == store.ledger.page_in_bytes


def test_shared_link_budget_serializes_like_the_reference(port_dir):
    """Two pagers on one LinkBudget queue on the wire; every transfer and
    the link's aggregates equal the JAX package's on the same schedule."""
    keys = [(p, lvl) for p, e in open_artifact(port_dir)._by_path.items()
            for lvl in range(len(e["arrays"].get("deltas", ())))]
    out = []
    for Clock, Link, Throttled, Pager, kw in (
            (VirtualClock, LinkBudget, ThrottledPager, FilePager, {"device": "cpu"}),
            (JaxClock, JaxLinkBudget, JaxThrottled, JaxFilePager, {})):
        clock = Clock()
        link = Link(bandwidth_bytes_per_s=1e6, latency_s=2e-3)
        a = Throttled(Pager(port_dir, **kw), clock=clock, link=link)
        b = Throttled(Pager(port_dir, **kw), clock=clock, link=link, sleep=True)
        for i, (path, lvl) in enumerate(keys):
            (a if i % 3 else b).fetch(path, lvl)
            clock.set(clock.now() + 1e-3 * (i % 2))
        out.append((a.transfers, b.transfers, a.simulated_seconds, b.simulated_seconds,
                    link.busy_until, link.bytes_moved, link.busy_s, link.queued_s,
                    link.transfers, clock.now()))
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        LinkBudget(bandwidth_bytes_per_s=0)


def test_corruption_raises_corrupt_stream_error_an_artifact_error(ref_dir, tmp_path):
    """A flipped byte in a delta array fails its CRC-32 on fetch: the error
    is a ``CorruptStreamError`` and, as in the JAX package, an
    ``ArtifactError``; the failed upgrade rolls back and serving goes on.
    A flipped byte in the base segment fails its SHA-256 at boot."""
    bad = str(tmp_path / "bad")
    shutil.copytree(ref_dir, bad)
    art = open_artifact(bad)
    spec = art.leaf("['blocks']['q']['w']")["arrays"]["deltas"][0]
    with open(os.path.join(bad, "delta_0.seg"), "r+b") as f:
        f.seek(spec["offset"] + 3)
        byte = f.read(1)
        f.seek(spec["offset"] + 3)
        f.write(bytes([byte[0] ^ 0x10]))
    with pytest.raises(ArtifactError, match="CRC-32") as info:
        FilePager(art, device="cpu").fetch("['blocks']['q']['w']", 0)
    assert isinstance(info.value, CorruptStreamError)
    assert "level 0" in str(info.value)
    eng = ServeEngine.from_artifact(get_config("qwen2-1.5b").reduced(), bad,
                                    max_batch=1, max_len=16, device="cpu")
    before = eng.store.ledger.events[:]
    rep = eng.poll_delivery()
    assert rep["rung"] == 0 and "CRC-32" in rep["failed"]
    assert eng.store.ledger.events == before and eng.store.pager.resident_bytes() == 0
    assert eng.stats.switch_failures == 1
    # the same fetch without verification reads the flipped words
    assert FilePager(art, verify=False, device="cpu").fetch(
        "['blocks']['q']['w']", 0).dtype == torch.int32
    with open(os.path.join(bad, "base.seg"), "r+b") as f:
        f.seek(11)
        byte = f.read(1)
        f.seek(11)
        f.write(bytes([byte[0] ^ 0x01]))
    with pytest.raises(ArtifactError, match="SHA-256"):
        load_store(bad, device="cpu")


def test_refusals_paged_out_tree_sequence_nodes_and_missing_segments(trees, tmp_path):
    store = NestQuantStore(trees[2], mode="part", device="cpu")
    with pytest.raises(ArtifactError, match="paged out"):
        save_artifact(store.nested_params, str(tmp_path / "a"))
    assert not os.path.exists(str(tmp_path / "a"))
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp_artifact_")]
    with pytest.raises(ArtifactError, match="dicts only"):
        save_artifact({"a": [torch.zeros(2)]}, str(tmp_path / "b"))
    # the JAX package writes list nodes as {"i": ...} elements
    jax_save({"a": [jnp.ones(3, jnp.bfloat16)]}, str(tmp_path / "c"))
    with pytest.raises(ArtifactError, match="sequence"):
        open_artifact(str(tmp_path / "c")).load_base_tree("cpu")
    stage = _stage(str(tmp_path / "c"), str(tmp_path / "d"), ("manifest.json",))
    with pytest.raises(ArtifactError, match="not delivered"):
        open_artifact(stage).load_base_tree("cpu")


def test_dense_bf16_and_f32_leaves_round_trip_both_ways(tmp_path):
    """bf16 leaves travel as raw 16-bit patterns under the name
    'bfloat16': the port reads the JAX package's and the other way round."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    jtree = {"b": jnp.asarray(x, jnp.bfloat16), "f": jnp.asarray(x), "s": jnp.float32(2.5)}
    jax_save(jtree, str(tmp_path / "j"))
    ptree = open_artifact(str(tmp_path / "j")).load_base_tree("cpu")
    # a scalar is written 1-d by both packages (numpy.ascontiguousarray)
    assert ptree["b"].dtype == torch.bfloat16 and ptree["s"].shape == (1,)
    np.testing.assert_array_equal(t2n(ptree["b"]), np.asarray(jtree["b"], np.float32))
    np.testing.assert_array_equal(t2n(ptree["f"]), x)
    save_artifact(ptree, str(tmp_path / "p"))
    back = jax_open(str(tmp_path / "p")).load_base_tree()
    for k in jtree:
        assert back[k].dtype == jtree[k].dtype
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(jtree[k]))
    for f in ("base.seg", "manifest.json"):
        assert _sha(str(tmp_path / "p" / f)) == _sha(str(tmp_path / "j" / f))


def test_file_pager_fetch_equals_in_memory_pager(trees, port_dir):
    """Every FilePager fetch equals the in-memory stream bit for bit, and
    its residency counts what is fetched and not yet evicted; the expected
    CRC-32s agree."""
    mem = InMemoryPager.from_tree(trees[2])
    fp = FilePager(port_dir, device="cpu")
    total = 0
    for (path, lvl), words in mem._streams.items():
        got = fp.fetch(path, lvl)
        assert got.dtype == torch.int32 and torch.equal(got, words)
        assert fp.expected_crc(path, lvl) == mem.expected_crc(path, lvl)
        total += words.numel() * 4
    assert fp.resident_bytes() == total
    for path, lvl in mem._streams:
        fp.evict(path, lvl)
    assert fp.resident_bytes() == 0
    assert fp.expected_crc("['nope']", 0) is None and not fp.available("['nope']", 0)
