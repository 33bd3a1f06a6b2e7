"""Port parity of the serve and fleet CLIs: ``main([...])`` of both
packages, run with ``capsys`` on the reduced qwen2-1.5b, print the same
lines wherever a line depends only on shapes, bytes and the virtual
clock - the store line, the trace line, the ``[load]`` table, the switch
lines, the chaos line, the budget-schedule ledgers, the artifact and link
lines, the fleet table and the ``--json`` report.

Masked (and only these):

* the wall-clock seconds of a budget-schedule phase (``[phase ...] ... in
  <s>s``): the host's time, not the model's;
* with ``--speculate``, the acceptance and the accepted-token count, and
  with ``--policy quality`` and ``--search-recipe`` the rung choices and
  dB scores: they depend on the weights, and the two CLIs draw different
  random weights (``jax.random`` against a ``torch.Generator``), so those
  lines are held for shape only.

The port runs with ``--device cpu`` (the kernels' plain versions).  The
JAX package's runs share one jitted quantization and one compile per
(rung, shape) across the module (``torch_parity.shared_jax_compiles``);
what they print does not change."""
import argparse
import json
import re

import jax
import pytest

import repro.api as japi
import repro.launch.fleet as jfleet_cli
import repro.launch.serve as jserve_cli
from repro.core.recipe import quantize as jax_quantize
from repro_torch.launch import fleet as pfleet_cli
from repro_torch.launch import flags as pflags
from repro_torch.launch import serve as pserve_cli
from torch_parity import shared_jax_compiles

ARCH = ["--arch", "qwen2-1.5b", "--smoke"]
WALL = re.compile(r" in \d+\.\d+s;")


@pytest.fixture(scope="module", autouse=True)
def jax_caches():
    """One jitted quantization per (recipe, parameter shapes) for the JAX
    CLIs (their weights are always ``PRNGKey(0)``'s for a config), and
    shared compiles."""
    done = {}

    def quantize(params, recipe):
        key = (recipe.to_json(), str(jax.tree_util.tree_map(lambda x: x.shape, params)))
        if key not in done:
            done[key] = jax.jit(lambda p: jax_quantize(p, recipe))(params)
        return done[key]

    with shared_jax_compiles(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserve_cli, "quantize", quantize)
        mp.setattr(japi, "quantize", quantize)
        yield


def _both(capsys, jmain, pmain, args, port_args=()):
    """Stdout lines of the JAX CLI and of the port's (on the CPU)."""
    jmain(args)
    ref = capsys.readouterr().out.splitlines()
    pmain([*args, "--device", "cpu", *port_args])
    return ref, capsys.readouterr().out.splitlines()


def _unwall(lines):
    return [WALL.sub(" in <wall>s;", line) for line in lines]


def test_serve_burst_trace_through_faults(capsys):
    args = [*ARCH, "--bits", "8,6,4", "--trace", "burst", "--requests", "40",
            "--new-tokens", "2", "--max-batch", "4", "--policy", "failure", "--chaos"]
    ref, port = _both(capsys, jserve_cli.main, pserve_cli.main, args)
    assert port == ref
    assert [line.split(" ")[0] for line in port[:3]] == ["[store]", "[trace", "[load]"]
    assert port[-1].startswith("[chaos]") and "all requests served: 40/40" in port[-1]
    assert any(line.startswith("  step ") for line in port)


def test_serve_budget_schedule_and_artifact(capsys, tmp_path):
    sched = ["--budget-schedule", "full,part,rung1,full", "--requests", "4",
             "--new-tokens", "2"]
    ref, port = _both(capsys, jserve_cli.main, pserve_cli.main,
                      [*ARCH, "--bits", "8,6,4", *sched])
    assert _unwall(port) == _unwall(ref)
    assert [line.split(" ")[0] for line in port] == \
        ["[store]", "[phase", "[phase", "[phase", "[phase", "[switching]"]
    out = []
    for name, main in (("jax", jserve_cli.main), ("port", pserve_cli.main)):
        art = str(tmp_path / name)
        extra = [] if name == "jax" else ["--device", "cpu"]
        main([*ARCH, "--bits", "8,6,4", "--save-artifact", art, *extra])
        saved = capsys.readouterr().out.replace(art, "<dir>").splitlines()
        main([*ARCH, "--artifact", art, "--link-mbps", "100", *sched, *extra])
        out.append((saved, _unwall(capsys.readouterr().out.splitlines())))
    assert out[1] == out[0]
    saved, served = out[1]
    assert saved[-1] == "[artifact] wrote <dir>" and len(saved) == 4
    assert served[0].startswith("[artifact] cold boot read")
    assert served[-1].startswith("[link] paged")


def test_serve_moe_budget_schedule(capsys):
    """The MoE family through the serve CLI: reduced dbrx-132b (4 experts,
    top-2) over a budget schedule that walks every rung prints the JAX
    CLI's lines but for the wall seconds."""
    args = ["--arch", "dbrx-132b", "--smoke", "--bits", "8,6,4", "--budget-schedule",
            "full,part,rung1,full", "--requests", "4", "--new-tokens", "2"]
    ref, port = _both(capsys, jserve_cli.main, pserve_cli.main, args)
    assert _unwall(port) == _unwall(ref)
    assert [line.split(" ")[0] for line in port] == \
        ["[store]", "[phase", "[phase", "[phase", "[phase", "[switching]"]


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_serve_ssm_budget_schedule(capsys, arch):
    """The ssm and hybrid families through the serve CLI: reduced
    mamba2-780m and zamba2-2.7b over a budget schedule that walks every
    rung print the JAX CLI's lines but for the wall seconds."""
    args = ["--arch", arch, "--smoke", "--bits", "8,6,4", "--budget-schedule",
            "full,part,rung1,full", "--requests", "4", "--new-tokens", "2"]
    ref, port = _both(capsys, jserve_cli.main, pserve_cli.main, args)
    assert _unwall(port) == _unwall(ref)
    assert [line.split(" ")[0] for line in port] == \
        ["[store]", "[phase", "[phase", "[phase", "[phase", "[switching]"]


def test_serve_speculative_trace(capsys):
    """Two new tokens per request: every batch's one draft/verify round is
    charged the same virtual time whatever the drafts' acceptance, so only
    the acceptance figures are masked."""
    args = [*ARCH, "--bits", "8,6,4", "--trace", "poisson", "--requests", "16",
            "--new-tokens", "2", "--max-batch", "4", "--speculate", "2", "--draft-rung", "0"]
    ref, port = _both(capsys, jserve_cli.main, pserve_cli.main, args)
    accept = re.compile(r"acceptance=\d\.\d{3} \((\d+)/(\d+) tokens\)")

    def shape(lines):
        return [accept.sub(lambda m: f"acceptance=<x> (<a>/{m.group(2)} tokens)", line)
                for line in lines]

    assert shape(port) == shape(ref)
    assert port[2].startswith("[speculate] armed k=2 draft=0; warmup pre-traced")
    assert sum(1 for line in port if accept.search(line)) == 1


def test_serve_quality_policy_shape(capsys):
    """``--policy quality`` picks rungs from the weights' quantization error,
    so the phases' rungs and ledgers are held for shape only."""
    args = [*ARCH, "--bits", "8,6,4", "--policy", "quality", "--budget-schedule",
            "part,full", "--requests", "4", "--new-tokens", "2"]
    ref, port = _both(capsys, jserve_cli.main, pserve_cli.main, args)
    num = re.compile(r"\d+(\.\d+)?")
    assert [num.sub("<n>", line) for line in port] == [num.sub("<n>", line) for line in ref]
    assert port[0] == ref[0]                        # the store line is bytes only


def test_serve_search_recipe(capsys, tmp_path):
    """``--search-recipe none``: the table and the JSON the CLI prints and
    writes are the port's ``search_recipe`` on the CLI's weights, whose
    parity with the JAX package's is tests/test_torch_search.py's; the
    unbudgeted search keeps every layer's full chain."""
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import QuantRecipe, quantize, recipe_summary
    from repro_torch.core.search import search_recipe
    from repro_torch.models.model import make_model

    out = tmp_path / "search.json"
    pserve_cli.main([*ARCH, "--bits", "8,6,4", "--search-recipe", "none",
                     "--search-out", str(out), "--budget-schedule", "full",
                     "--requests", "4", "--new-tokens", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    cfg = get_config("qwen2-1.5b").reduced()
    params = make_model(cfg, device="cpu").init(0)
    res = search_recipe(params, None, bits=(8, 6, 4), seed=0)
    table = ("[search] " + res.table()).splitlines()
    summary = recipe_summary(quantize(params, res.recipe, device="cpu")).splitlines()
    assert lines[:len(table)] == table
    assert lines[len(table):len(table) + 2] == [f"[search] wrote {out}", "[recipe] per-leaf ladders:"]
    assert lines[len(table) + 2:len(table) + 2 + len(summary)] == summary
    assert out.read_text() == res.to_json()
    assert all(top == 2 for _, top in res.tops)
    assert res.recipe.bits == QuantRecipe(bits=(8, 6, 4)).bits
    assert [line.split(" ")[0] for line in lines[-3:]] == ["[store]", "[phase", "[switching]"]


def test_fleet_cli_table_and_json(capsys, tmp_path):
    args = [*ARCH, "--replicas", "4", "--trace", "burst", "--requests", "12",
            "--new-tokens", "2", "--max-batch", "4", "--policy", "failure", "--chaos"]
    jpath, ppath = tmp_path / "jax.json", tmp_path / "port.json"
    jfleet_cli.main([*args, "--json", str(jpath)])
    ref = capsys.readouterr().out.replace(str(jpath), "<out>").splitlines()
    pfleet_cli.main([*args, "--json", str(ppath), "--device", "cpu"])
    port = capsys.readouterr().out.replace(str(ppath), "<out>").splitlines()
    assert port == ref
    assert port[0].startswith("[fleet] 4 replicas over one") and len(port) == 8
    assert json.loads(ppath.read_text()) == json.loads(jpath.read_text())


def test_fleet_cli_emit_k8s(tmp_path):
    manifests = []
    for mod, name in ((jfleet_cli, "jax"), (pfleet_cli, "port")):
        path = tmp_path / f"{name}.yaml"
        mod.main([*ARCH, "--replicas", "16", "--emit-k8s", str(path)])
        manifests.append(path.read_text())
    assert manifests[1] == manifests[0].replace("repro.", "repro_torch.")
    assert '"repro_torch.launch.serve"' in manifests[1] and "completions: 16" in manifests[1]


def test_flags_equal_the_reference():
    from repro.launch import flags as jflags

    ap = argparse.ArgumentParser(parents=[pflags.traffic_parent()])
    jap = argparse.ArgumentParser(parents=[jflags.traffic_parent()])
    assert vars(ap.parse_args([])) == vars(jap.parse_args([]))
    assert (pflags.POLICY_CHOICES, pflags.TRACE_CHOICES) == \
        (jflags.POLICY_CHOICES, jflags.TRACE_CHOICES)
    args = ap.parse_args(["--chaos", "--chaos-seed", "3", "--retry-attempts", "2"])
    prof, jprof = pflags.chaos_profile(args, extra_seed=2), jflags.chaos_profile(args, 2)
    assert vars(prof) == vars(jprof) and prof.seed == 5
    assert pflags.chaos_profile(ap.parse_args([])) is None
    for main in (pserve_cli.main, pfleet_cli.main):
        with pytest.raises(SystemExit):
            main([*ARCH, "--policy", "load", "--device", "cpu"] if main is pserve_cli.main
                 else [*ARCH, "--replicas", "0", "--device", "cpu"])
