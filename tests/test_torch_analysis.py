"""The port's analysis layer (``repro_torch.analysis``) on the CPU.

* the op census of the ten entry points against the reference's
  checked-in ``ANALYSIS_BUDGETS.json``, field by field (``FIELD_MAP``);
  every field that differs is named in ``DIFFERENCES`` with its reason and
  held to the port's own value or relation there;
* the census against the port's own ``analysis/budgets.json``;
* each structural rule, holding on the tree and failing, by its field, on
  a crafted drift; the budget diff, its waivers and ``update_budgets``;
* each AST rule firing on a crafted snippet, and the port's tree clean
  after its waivers;
* the CLI.

The reference side is its checked-in budget file: nothing here runs JAX.
"""
import copy
import json
import os
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import astlint, census
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import p2m_conv as pk

ROOT = Path(__file__).resolve().parents[1]
REF_BUDGETS = json.loads((ROOT / "ANALYSIS_BUDGETS.json").read_text())

ENTRIES = ("frontend.ideal", "frontend.analog", "frontend.device",
           "frontend.cuda", "stream.exact", "stream.fused", "fleet.g1",
           "fleet.g2", "quant.fused_q8", "train.step")
# the reference's entry each port entry is held against
REF_ENTRY = {"frontend.cuda": "frontend.pallas"}
# every field of the reference's census -> the port's field (block, name);
# None: not compared (see DIFFERENCES)
FIELD_MAP = {
    ("jaxpr", "conv"): ("ops", "conv"),
    ("jaxpr", "dot_general"): ("ops", "dot"),
    ("jaxpr", "dot_f32"): ("ops", "dot_f32"),
    ("jaxpr", "dot_i8"): ("ops", "dot_i8"),
    ("jaxpr", "dot_i8_sig"): ("ops", "dot_i8_sig"),
    ("jaxpr", "pallas_call"): ("ops", "kernel_calls"),
    ("jaxpr", "gather"): ("ops", "gather"),
    ("jaxpr", "scatter"): ("ops", "scatter"),
    ("jaxpr", "f64_convert"): ("ops", "f64"),
    ("jaxpr", "host_callback"): ("ops", "host_sync"),
    ("jaxpr", "rng"): ("ops", "rng"),
    ("jaxpr", "eqn_count"): None,
    ("hlo", "conv_count"): ("ops", "conv"),
    ("hlo", "dot_count"): ("ops", "dot"),
    ("hlo", "conv_flops"): ("flops", "conv_flops"),
    ("hlo", "dot_flops"): ("flops", "dot_flops"),
    ("hlo", "matmul_flops"): ("flops", "matmul_flops"),
}

_KEY_WORDS = ("the reference's typed key is wrapped and unwrapped "
              "(random_wrap, random_unwrap) to hand its kernel the two key "
              "words; a port key is those words already (a (2,) uint32 "
              "array), and the kernel wrapper reads them as part of its "
              "kernel call")
_GRID_STEP = ("the reference's HLO census is static and counts the dot of "
              "its interpret-mode kernel A once: one grid step of its patch "
              "rows (of `steps`, the chip axis included); the port counts "
              "kernel A's whole (G, N, 27) x (27, 64) product")
# (port entry, reference field) -> (how the port's value is held, reason):
# ("value", v) pins the port at v; ("grid_steps", s) holds the kernel's
# product at s reference grid steps (the rest of the field equal);
# ("entry", name) compares with another reference entry; ("skip",) is not
# compared
DIFFERENCES = {
    **{(e, ("jaxpr", "eqn_count")): (
        ("skip",), "jaxpr equations and aten ops are not the same unit; "
                   "the port's op_count is pinned in its own budget file")
       for e in ENTRIES},
    **{(e, ("jaxpr", "rng")): (("value", 0), _KEY_WORDS)
       for e in ("frontend.cuda", "stream.exact", "stream.fused",
                 "fleet.g1", "fleet.g2", "quant.fused_q8")},
    ("frontend.device", ("jaxpr", "rng")): (
        ("value", 1), "the reference counts random_wrap and random_bits; "
                      "the port's draw is one prng.bernoulli call on a raw "
                      "key"),
    ("stream.fused", ("jaxpr", "host_callback")): (
        ("value", 1), "the port's entry is VisionEngine._fused_classify, "
                      "whose drift guard reads the fresh theta on the host "
                      "(float(out['theta'])); the reference's jitted "
                      "_fused_step leaves that read to its caller"),
    **{(e, ("jaxpr", "gather")): (
        ("value", 7), "the port's entry is FleetEngine._run_step, which "
                      "gathers the step's chips and trims (one index_select "
                      "for each of the six ChipMaps leaves and the trims); "
                      "the reference's _step takes them gathered")
       for e in ("fleet.g1", "fleet.g2")},
    ("quant.fused_q8", ("jaxpr", "dot_i8_sig")): (
        ("entry", "quant.fused_q8_mxu"),
        "the port's one int8 kernel sums in int32 (MacQ8Mma), as the "
        "reference's real-MXU trace does; its interpret-mode "
        "quant.fused_q8 sums in float32"),
    **{(e, ("hlo", f)): (("grid_steps", s), _GRID_STEP)
       for e, s in (("frontend.cuda", 2), ("stream.exact", 2),
                    ("fleet.g1", 2), ("fleet.g2", 4))
       for f in ("dot_flops", "matmul_flops")},
}
# kernel A's product at the census shapes: (chips, frames) of each entry
KERNEL_A_FRAMES = {"frontend.cuda": (1, census.FRONTEND_BATCH),
                   "stream.exact": (1, census.STREAM_BATCH),
                   "fleet.g1": (1, census.FLEET_BATCH),
                   "fleet.g2": (2, census.FLEET_BATCH)}


@pytest.fixture(autouse=True)
def _no_tile_table(monkeypatch):
    """The census resolves each step's precision from an empty table (f32)
    whatever tables earlier tests loaded."""
    monkeypatch.setattr(autotune, "_TABLE", {})


@pytest.fixture(scope="module")
def results():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(autotune, "_TABLE", {})
        return census.collect()


def _kernel_a_flops(entry: str) -> int:
    g, b = KERNEL_A_FRAMES[entry]
    return 2 * g * b * 16 * 16 * 27 * 64


# --- (a) against the reference's budget file --------------------------------

def test_every_reference_field_is_mapped():
    for entry in set(REF_ENTRY.get(e, e) for e in ENTRIES):
        ref = REF_BUDGETS["census"][entry]
        for block, fields in ref.items():
            for field in fields:
                assert (block, field) in FIELD_MAP, (entry, block, field)


@pytest.mark.parametrize("entry", ENTRIES)
def test_census_against_the_reference(results, entry):
    ref = REF_BUDGETS["census"][REF_ENTRY.get(entry, entry)]
    got = results[entry]
    compared = 0
    for (block, field), port in FIELD_MAP.items():
        if field not in ref.get(block, {}):
            continue
        rule, _reason = DIFFERENCES.get((entry, (block, field)),
                                        (("equal",), ""))
        if rule[0] == "skip":
            continue
        want = ref[block][field]
        have = got[port[0]][port[1]]
        if rule[0] == "equal":
            assert have == want, (entry, block, field, have, want)
        elif rule[0] == "value":
            assert have == rule[1] != want, (entry, field, have, want)
        elif rule[0] == "entry":
            other = REF_BUDGETS["census"][rule[1]][block][field]
            assert have == other != want, (entry, field, have, other)
        else:                                          # grid_steps
            kernel = _kernel_a_flops(entry)
            rest = got["flops"]["dot_flops"] - kernel  # the head's product
            ref_step = ref["hlo"]["dot_flops"] - rest
            assert kernel == rule[1] * ref_step, (entry, kernel, ref_step)
            assert have - want == kernel - ref_step, (entry, field)
        compared += 1
    assert compared >= 15


def test_fleet_and_int8_structure_is_pinned(results):
    one_a_one_b = {"p2m_phase_a_implicit_fleet": 1, "p2m_phase_b_fleet": 1}
    assert results["fleet.g1"]["kernels"] == one_a_one_b
    assert results["fleet.g2"]["kernels"] == one_a_one_b
    q8 = results["quant.fused_q8"]["ops"]
    assert (q8["dot"], q8["dot_i8"], q8["dot_f32"]) == (1, 1, 0)
    assert q8["dot_i8_sig"] == "4096x27:int8x27x64:int8->int32" == \
        REF_BUDGETS["census"]["quant.fused_q8_mxu"]["jaxpr"]["dot_i8_sig"]
    assert results["frontend.cuda"]["kernels"] == {"p2m_phase_a_implicit": 1,
                                                   "p2m_phase_b": 1}
    assert results["stream.fused"]["kernels"] == {"p2m_fused_stream": 1}


# --- (b) against the port's own budget file ----------------------------------

def test_census_equals_the_port_budgets(results):
    budgets = census.load_budgets()
    assert census.check(results, budgets) == []
    assert sorted(budgets["census"]) == sorted(ENTRIES)


# --- (c) the structural rules ------------------------------------------------

def test_structural_rules_hold(results):
    assert census.structural_failures(results) == []
    ideal = results["frontend.ideal"]["flops"]["matmul_flops"]
    cuda = results["frontend.cuda"]["flops"]["matmul_flops"]
    assert cuda == census.PHASES * ideal
    g1 = results["fleet.g1"]["flops"]["matmul_flops"]
    assert results["fleet.g2"]["flops"]["matmul_flops"] == 2 * g1


def _drifted(monkeypatch, group, target, name, wrap):
    original = getattr(target, name)
    monkeypatch.setattr(target, name, wrap(original))
    return census.structural_failures(census.collect([group]))


def _extra_conv(fn):
    def frontend(images, w, *args, **kwargs):
        # one frame's conv: the flops stay inside the budget, so the conv
        # count alone fails
        F.conv2d(images[:1].permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=2)
        return fn(images, w, *args, **kwargs)
    return frontend


def _twice(fn, when=lambda images: True):
    def kernel(images, *args, **kwargs):
        if when(images):
            fn(images, *args, **kwargs)
        return fn(images, *args, **kwargs)
    return kernel


def _f32_dot(fn):
    def fused(images, *args, **kwargs):
        images.reshape(-1, 3) @ torch.ones((3, 3))
        return fn(images, *args, **kwargs)
    return fused


def _f32_accumulator(fn):
    def dots(*args, **kwargs):
        return [census.cuda_lib.Dot(d.lhs, d.rhs, d.dtype, "float32")
                for d in fn(*args, **kwargs)]
    return dots


DRIFTS = {
    "extra_conv_in_cuda_frontend": (
        "frontend", ops, "p2m_frontend", _extra_conv,
        ["frontend.cuda.ops.conv: expected 0, got 1"]),
    "second_kernel_a_in_cuda_frontend": (
        "frontend", ops, "p2m_phase_a_implicit", _twice,
        ["frontend.cuda.ops.dot: expected 1, got 2",
         "frontend.cuda.flops.matmul_flops: 28311552"]),
    "second_kernel_a_in_fleet_g2": (
        "fleet", pk, "p2m_phase_a_implicit_fleet",
        lambda fn: _twice(fn, lambda images: images.shape[0] == 2),
        ["fleet.ops.kernel_calls: G=1 has 2, G=2 has 3",
         "fleet.ops.dot: G=1 has 2, G=2 has 3", "fleet.kernels: ",
         "fleet.flops.matmul_flops: G=2 (160452608)"]),
    "f32_dot_in_q8_path": (
        "quant", ops, "p2m_fused_stream_q8", _f32_dot,
        ["quant.fused_q8.ops.dot_f32: expected 0, got 1"]),
    "f32_accumulator_in_q8_kernel": (
        "quant", pk.p2m_fused_stream_q8, "dots", _f32_accumulator,
        ["quant.fused_q8.ops.dot_i8_sig: accumulator must be int32"]),
}


@pytest.mark.parametrize("drift", sorted(DRIFTS))
def test_structural_rule_fails_on_a_crafted_drift(drift, monkeypatch):
    group, target, name, wrap, expected = DRIFTS[drift]
    fails = _drifted(monkeypatch, group, target, name, wrap)
    for text in expected:
        assert any(f.startswith(text) for f in fails), (text, fails)
    assert len(fails) == len(expected), fails


# --- (d) the budget diff, its waivers and update_budgets --------------------

def _budgets():
    return copy.deepcopy(census.load_budgets())


@pytest.mark.parametrize("delta", [1, -1])
def test_budget_diff_fails_either_way(results, delta):
    budgets = _budgets()
    budgets["census"]["stream.exact"]["ops"]["conv"] += delta
    fails = census.budget_failures(results, budgets)
    assert fails == [f"stream.exact.ops.conv: budget {3 + delta}, "
                     "current 3"]


def test_budget_diff_names_missing_and_extra_fields(results):
    budgets = _budgets()
    del budgets["census"]["fleet.g2"]["flops"]["dot_flops"]
    budgets["census"]["fleet.g1"]["ops"]["retired_field"] = 0
    del budgets["census"]["train.step"]
    fails = census.budget_failures(results, budgets)
    assert fails == [
        "fleet.g1.ops.retired_field: in budget (0) but missing from the "
        "census — stale budget",
        "fleet.g2.flops.dot_flops: censused (14176256.0) but absent from "
        "the budget — stale budget",
        "train.step: censused entry point has no budget — stale budget "
        "file"]


def test_census_waivers_need_a_reason(results):
    budgets = _budgets()
    budgets["census"]["stream.exact"]["ops"]["op_count"] += 5
    budgets["waivers"]["census"] = [{"entry": "stream.exact",
                                     "field": "ops.op_count",
                                     "reason": "torch version moved it"}]
    assert census.budget_failures(results, budgets) == []
    budgets["waivers"]["census"][0]["reason"] = ""
    with pytest.raises(ValueError, match="has no reason"):
        census.budget_failures(results, budgets)


def test_op_count_is_compared_under_the_pinned_torch_version(results):
    budgets = _budgets()
    assert budgets["torch_version"] == torch.__version__
    budgets["census"]["frontend.ideal"]["ops"]["op_count"] += 5
    assert census.budget_failures(results, budgets) == [
        f"frontend.ideal.ops.op_count: budget "
        f"{results['frontend.ideal']['ops']['op_count'] + 5}, current "
        f"{results['frontend.ideal']['ops']['op_count']}"]
    budgets["torch_version"] = "0.0"
    assert census.budget_failures(results, budgets) == []
    budgets["census"]["frontend.ideal"]["ops"]["conv"] = 2
    assert census.budget_failures(results, budgets) == [
        "frontend.ideal.ops.conv: budget 2, current 1"]


def test_update_budgets_round_trips_and_keeps_waivers(results, tmp_path):
    path = tmp_path / "budgets.json"
    doc = _budgets()
    doc["waivers"]["census"] = [{"entry": "fleet.g1", "field": "ops.gather",
                                 "reason": "a crafted waiver"}]
    path.write_text(json.dumps(doc))
    census.update_budgets(results, str(path))
    back = census.load_budgets(str(path))
    assert back["census"] == json.loads(json.dumps(results))
    assert back["waivers"] == doc["waivers"]
    assert census.check(results, back) == []


# --- (e) the AST rules -------------------------------------------------------

CORE = "V_HALF = 0.0625\nGAIN = 2.0\n"
SNIPPETS = {
    "physics-constants": ("mod.py", "def f():\n    return 0.0625\n"),
    "no-wallclock": ("mod.py", "import time\n\ndef f():\n"
                               "    return time.perf_counter()\n"),
    "no-host-rng": ("mod.py", "import torch\n\ndef f():\n"
                              "    return torch.rand((2,))\n"),
    "frozen-config": ("mod.py", "import dataclasses\n\n\n"
                                "@dataclasses.dataclass\nclass ToyConfig:\n"
                                "    n: int = 1\n"),
    "orphan-module": ("lonely.py", "X = 1\n"),
    "q8-f32-dot": ("kernels/mac.py", "def mac_q8(a, b):\n    return a @ b\n"),
}
# each rule's other findings on its own: (snippet, violations)
MORE_HOST_RNG = ("import random\nimport numpy as np\nimport torch\n"
                 "from repro_torch import prng\n\n\ndef f(x, g):\n"
                 "    np.random.rand(3)\n    torch.manual_seed(0)\n"
                 "    x.normal_()\n    prng.PRNGKey(3)\n"
                 "    torch.randn((2,), generator=g)\n"
                 "    x.normal_(generator=g)\n")


def _toy_repo(root: Path, rel: str, source: str) -> None:
    pkg = root / "src" / "repro_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "kernels").mkdir()
    (pkg / "obs").mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "core" / "phys.py").write_text(CORE)
    (pkg / "obs" / "clock.py").write_text(
        "import time\n\ndef now():\n    return time.perf_counter()\n")
    (pkg / rel).write_text(source)
    (root / "tests").mkdir()
    (root / "tests" / "test_toy.py").write_text(
        "import repro_torch.core.phys\nimport repro_torch.obs.clock\n"
        "import repro_torch.mod\nimport repro_torch.kernels.mac\n")


@pytest.mark.parametrize("rule", astlint.RULES)
def test_ast_rule_fires_on_a_crafted_snippet(rule, tmp_path):
    rel, source = SNIPPETS[rule]
    _toy_repo(tmp_path, rel, source)
    found = astlint.lint_repo(str(tmp_path))
    assert [(v.rule, v.path) for v in found] == [
        (rule, f"src/repro_torch/{rel}")], found
    # an inline waiver on the flagged line, or a waiver with a reason, clears
    remaining, waived = astlint.run(str(tmp_path), [
        {"rule": rule, "path": f"src/repro_torch/{rel}", "reason": "toy"}])
    assert remaining == [] and len(waived) == 1
    if rule != "orphan-module":
        lines = source.splitlines()
        i = found[0].lineno - 1
        lines[i] += f"  # analysis: waive={rule}"
        (tmp_path / "src" / "repro_torch" / rel).write_text(
            "\n".join(lines) + "\n")
        assert astlint.lint_repo(str(tmp_path)) == []


def test_host_rng_rule_finds_every_form(tmp_path):
    _toy_repo(tmp_path, "mod.py", MORE_HOST_RNG)
    found = astlint.lint_repo(str(tmp_path))
    assert {v.rule for v in found} == {"no-host-rng"}
    assert sorted(v.lineno for v in found) == [1, 8, 9, 10, 11]


def test_ast_waivers_need_a_reason(tmp_path):
    _toy_repo(tmp_path, "lonely.py", "X = 1\n")
    with pytest.raises(ValueError, match="has no reason"):
        astlint.run(str(tmp_path), [{"rule": "orphan-module",
                                     "path": "src/repro_torch/lonely.py"}])


def test_the_port_is_clean_after_its_waivers():
    waivers = census.load_budgets()["waivers"]["ast"]
    remaining, waived = astlint.run(str(ROOT), waivers)
    assert remaining == [], "\n".join(map(str, remaining))
    assert {v.path for v in waived} == {w["path"] for w in waivers}


# --- (f) the CLI -------------------------------------------------------------

def test_cli_exits_zero_on_the_cpu(capsys):
    assert cli.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ast pass: 0 violation(s)" in out
    assert "census: 10 entry points, 0 failure(s)" in out


def test_cli_exits_one_on_a_stale_budget_file(results, tmp_path, capsys,
                                             monkeypatch):
    monkeypatch.setattr(census, "collect", lambda *a, **k: results)
    doc = _budgets()
    doc["census"]["frontend.cuda"]["ops"]["kernel_calls"] = 3
    path = tmp_path / "stale.json"
    path.write_text(json.dumps(doc))
    assert cli.main(["--device", "cpu", "--census-only", "--budgets",
                     str(path)]) == 1
    err = capsys.readouterr().err
    assert "frontend.cuda.ops.kernel_calls: budget 3, current 2" in err


def test_cli_update_leaves_the_budget_file_unchanged(results, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(census, "collect", lambda *a, **k: results)
    path = tmp_path / "budgets.json"
    original = Path(census.default_budgets_path()).read_bytes()
    path.write_bytes(original)
    assert cli.main(["--device", "cpu", "--census-only", "--update-budgets",
                     "--budgets", str(path)]) == 0
    assert path.read_bytes() == original


def test_cli_without_a_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--ast-only"])


def test_census_in_a_child_equals_the_census_in_process(results):
    """``collect_in_child`` (the card test's census, in a fresh
    interpreter) returns what ``collect`` returns here, through JSON."""
    assert census.collect_in_child(device="cpu") == results


def test_census_child_failure_names_the_cause():
    with pytest.raises(RuntimeError, match="unknown census group"):
        census.collect_in_child(["no_such_group"], device="cpu")


def test_budget_file_is_beside_the_census_module():
    assert os.path.dirname(census.default_budgets_path()) == \
        str(ROOT / "src" / "repro_torch" / "analysis")
