"""The port's tour on the CPU: ``examples/serve_switching_torch.py`` through
its ``main`` and each step of ``examples/quickstart_torch.py``, at the
reduced qwen2-1.5b config, holding what each prints or returns (the rung
walk, ledger bytes equal to bytes(delta_k), speculative tokens identical to
greedy)."""
import importlib.util
from pathlib import Path

import pytest
import torch

from conftest import assert_switch_records_exact
from repro_torch import tree
from repro_torch.core import NestedTensor

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_switching_walks_the_ladder_and_pages_one_stream_per_move(capsys):
    out = _example("serve_switching_torch").main(["--device", "cpu"])
    text = capsys.readouterr().out
    store = out["store"]
    # plenty, squeezed, mid, plenty: top, base, middle, top
    assert out["rungs"] == [2, 0, 1, 2]
    assert store.ledger.switches == len(store.ledger.events) == 6
    for r_from, r_to, pin, pout in store.ledger.events:
        assert abs(r_from - r_to) == 1
        assert (pin, pout) == ((store.delta_bytes(min(r_from, r_to)), 0) if r_to > r_from
                               else (0, store.delta_bytes(min(r_from, r_to))))
    assert 0 < out["switches"]["hysteresis"] < out["switches"]["budget"]
    reports = out["reports"]
    assert reports["static full"].switch_records == []
    assert reports["adaptive"].switch_records
    assert_switch_records_exact(reports["adaptive"].switch_records)
    for line in ("resident bytes per rung: rung0(int4)=", "[spike over] -> rung=2 (full)",
                 "== bytes(delta_1)", "hysteresis: 2 switches", "burst trace:"):
        assert line in text, text


# ---------------------------------------------------------------------------
# the quickstart's twelve steps, each a function of the ones before it
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qs():
    return _example("quickstart_torch")


@pytest.fixture(scope="module")
def model(qs):
    cfg, model, params = qs.step1_model(CPU)
    return cfg, model, params


@pytest.fixture(scope="module")
def nested(qs, model):
    h = qs.step2_nesting(model[2])
    assert h == 5                          # a 0.4 MB model: INT(8|5) by Eq. 12
    return h, qs.step3_quantize(model[2], h, CPU)


@pytest.fixture(scope="module")
def ladder(qs, model):
    ladder, store = qs.step6_ladder(model[2], CPU)
    return ladder, store


def test_steps_1_to_4_quantize_and_materialize(qs, model, nested):
    cfg, m, params = model
    h, tree_ = nested
    leaves = [x for x in tree.leaves(tree_) if isinstance(x, NestedTensor)]
    assert leaves and all(x.bits == (h, 8) for x in leaves)
    agree = qs.step4_materialize(cfg, m, params, tree_, CPU)
    assert set(agree) == {"part", "full"} and agree["full"] >= agree["part"] >= 0.5


def test_step_5_two_level_names_and_the_switch(qs, model, nested, capsys):
    h, tree_ = nested
    store = qs.step5_switch(model[2], tree_, h, CPU)
    text = capsys.readouterr().out
    assert store.rung == store.num_rungs - 1
    assert store.ledger.page_in_bytes == store.delta_bytes(0) > 0
    assert store.ledger.page_out_bytes == 0
    assert f"= INT{h} w_high" in text and f"{8 - h}-bit w_low" in text and "cheaper" in text


def test_step_6_ladder_climbs_one_delta_per_rung(ladder):
    _, store = ladder
    assert [(f, t, pin) for f, t, pin, _ in store.ledger.events] == \
        [(0, 1, store.delta_bytes(0)), (1, 2, store.delta_bytes(1))]


def test_step_7_hysteresis_switches_less(qs, model):
    switches = qs.step7_recipes(model[2], CPU)
    assert 0 < switches["hysteresis"] < switches["budget"]


def test_step_8_cold_boot_pages_the_deltas_from_disk(qs, ladder):
    cold = qs.step8_artifact(ladder[0], CPU)
    assert cold.rung == cold.num_rungs - 1
    assert [pin for _, _, pin, _ in cold.ledger.events] == \
        [cold.delta_bytes(k) for k in range(cold.num_rungs - 1)]


def test_step_9_burst_switches_page_bytes_delta_k(qs, model, ladder):
    report = qs.step9_burst(model[0], ladder[0], CPU)
    assert report.switch_records
    assert_switch_records_exact(report.switch_records)


def test_step_10_fleet_moves_fewer_bytes_than_unicast(qs, model, ladder):
    report = qs.step10_fleet(model[0], ladder[0], CPU)
    assert report.fleet_bytes < report.unicast_bytes
    assert report.verify_ledgers() > 0


def test_steps_11_and_12_speculative_tokens_and_the_nested_kv_cache(qs, model):
    cfg, _, params = model
    plain, spec_out, store = qs.step11_speculative(cfg, params, CPU)
    assert spec_out == plain and all(len(t) == 12 for t in plain)
    hi, lo = qs.step12_kv_cache(cfg, store, CPU)
    assert 0 < lo < hi
