"""The A/B scripts (scripts/p2m_ab.py, scripts/flash_ab.py,
scripts/rglru_ab.py, scripts/slstm_ab.py, scripts/lm_ab.py and the shared
scripts/ab_versions.py) on the CPU: what they can be asked without a card.

Every diagnostic copy must apply to the kernel source in this tree (a
renamed line would otherwise drop a stage from ``--diagnose`` unseen), the
turns must alternate the versions, the geometries are chip_smoke.py's,
the C 48 and ImageNet ones included, and lm_ab.py runs each served arch
as chip_smoke.py runs it.
"""
import ast
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")


@pytest.fixture
def scripts(monkeypatch):
    """Load a script by name with ``scripts/`` on the path, as
    ``python3 scripts/<name>.py`` runs it."""
    monkeypatch.syspath_prepend(SCRIPTS)

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(SCRIPTS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return load


@pytest.mark.parametrize("script,source,name", [
    *(("p2m_ab", "p2m_kernels.cu", n) for n in (
        "no_reductions", "no_chain", "const_gather", "no_curve", "short_mac",
        "no_store", "b_no_reductions", "b_no_chain", "b_const_chan",
        "q8_no_reductions", "q8_const_gather", "q8_no_store",
        "q8_no_curve", "f32_no_reductions", "f32_const_gather",
        "f32_no_curve", "f32_no_store", "f32_short_mac", "legacy_no_chain",
        "legacy_short_mac", "legacy_no_store")),
    *(("flash_ab", "flash_attention.cu", n) for n in (
        "no_exp", "no_softmax", "no_pv", "no_rescale", "no_kv_loads",
        "f32_no_exp", "f32_no_pv", "f32_no_loads", "f32_no_scores")),
    *(("slstm_ab", "slstm_scan.cu", n) for n in (
        "no_fma", "no_h_loads", "no_chain", "no_staging", "cluster16"))])
def test_each_diagnostic_changes_the_current_source(tmp_path, scripts,
                                                    script, source, name):
    ab = scripts(script)
    src = os.path.join(CSRC, source)
    paths = scripts("ab_versions").diagnostic_sources(src, str(tmp_path),
                                                      ab.DIAGNOSTICS)
    assert len(paths) == len(ab.DIAGNOSTICS)
    copy = open(dict(zip(ab.DIAGNOSTICS, paths))[name]).read()
    text = open(src).read()
    old, new = ab.DIAGNOSTICS[name]
    assert copy != text and text.count(old) == 1
    assert copy == text.replace(old, new)


def test_diagnostics_refuse_a_source_without_their_text(tmp_path, scripts):
    src = tmp_path / "other.cu"
    src.write_text("// no kernel here\n")
    with pytest.raises(ValueError, match="not in"):
        scripts("ab_versions").diagnostic_sources(
            str(src), str(tmp_path), scripts("p2m_ab").DIAGNOSTICS)


def test_turns_alternate_the_versions(scripts):
    order = []
    loaded = []
    out = scripts("ab_versions").in_turns(
        ["a", "b", "c"], 4, loaded.append,
        lambda: order.append(loaded[-1]) or len(order))
    assert order == ["a", "b", "c", "c", "b", "a", "a", "b", "c", "c", "b",
                     "a"]
    assert out == {"a": [1, 6, 7, 12], "b": [2, 5, 8, 11],
                   "c": [3, 4, 9, 10]}


def test_geometries_are_chip_smokes(scripts):
    geoms = scripts("p2m_ab").geometries()
    assert geoms["serving"] == dict(batch=16, h=32, w=32, kernel=3, stride=2,
                                    c=32)
    assert geoms["imagenet"] == dict(batch=16, h=224, w=224, kernel=3,
                                     stride=2, c=32)
    assert geoms["odd_k3s1_c48"]["c"] == 48
    assert len(geoms) == 5
    assert scripts("flash_ab").geometries()["granite_d128_b4"]["head_dim"] \
        == 128


@pytest.mark.parametrize("name", [
    "granite_d128_b4", "stablelm_d80_b4", "stablelm_d80_b1", "mha_d64_b4",
    "mha_d128_b4", "narrow_d32_toy", "f32_d128_toy", "narrow_d32_b4",
    "narrow_d16_b4", "f32_d128_b4", "f32_d16_b4", "rg_d256_b4",
    "rg_d256_s8192", "mla_d192_v128_b4", "kimi_d112_b4"])
def test_flash_geometries_name_their_dtype(scripts, name):
    """Each flash_ab.py geometry names its dtype and mode, is checked
    against chip_smoke.py's limit for that dtype, and the toy, _b4 and
    windowed (rg_) ones are chip_smoke.py's own flash lines."""
    ab = scripts("flash_ab")
    geoms = ab.geometries()          # puts the checkout's root on the path
    import chip_smoke as cs
    assert len(geoms) == 15
    geom = geoms[name]
    assert geom["dtype"] in ("bfloat16", "float32")
    assert isinstance(geom["causal"], bool)
    assert ab.checked_tolerance(geom) == cs.FLASH_TOL[geom["dtype"]] == {
        "bfloat16": 2e-2, "float32": 2e-5}[geom["dtype"]]
    toys = {"narrow_d32_toy": dict(batch=2, seq=130, heads=4, kv_heads=1,
                                   head_dim=32, dtype="bfloat16",
                                   causal=False),
            "f32_d128_toy": dict(batch=2, seq=256, heads=8, kv_heads=2,
                                 head_dim=128, dtype="float32",
                                 causal=False)}
    if name in toys:
        assert geom == toys[name] and geom in cs.FLASH_ODD
    if name.endswith("_b4") and name[:-3].split("_")[0] in ("narrow", "f32"):
        assert geom == cs.FLASH_B4[name] and geom in cs.FLASH_ODD
        assert (geom["batch"], geom["seq"], geom["heads"], geom["kv_heads"],
                geom["causal"]) == (4, 2048, 32, 8, True)
        assert geom["dtype"] == ("float32" if name.startswith("f32")
                                 else "bfloat16")
    if name.startswith("rg_"):
        assert geom in cs.FLASH_WINDOWED and geom["head_dim"] == 256
        assert (geom["window"], geom["dtype"]) == (2048, "bfloat16")
    if name.startswith(("mla_", "kimi_")):     # deepseek-v2's, kimi-k2's
        assert geom in cs.FLASH_MOE and geom["dtype"] == "bfloat16"
        assert (geom["head_dim"], geom.get("v_dim", 112)) in (
            (192, 128), (112, 112))


def test_a_source_from_before_the_value_dim_gets_the_shim(tmp_path,
                                                          scripts):
    """The current source is built as it is; one whose
    ``flash_attention_fwd`` takes no value dim is built from a copy with
    its entries renamed and wrapped in the current signatures."""
    ab = scripts("flash_ab")
    src = os.path.join(CSRC, "flash_attention.cu")
    assert ab.with_value_dim(src, str(tmp_path), 0) == src
    text = open(src).read()
    old = tmp_path / "old.cu"
    old.write_text(text.replace("int head_dim, int v_dim",
                                "int head_dim"))
    shimmed = ab.with_value_dim(str(old), str(tmp_path), 1)
    body = open(shimmed).read()
    assert shimmed != str(old)
    assert body.startswith(ab.SHIM_HEAD) and body.endswith(ab.SHIM_TAIL)
    assert "int v_dim" in ab.SHIM_TAIL and "_no_dv(" in ab.SHIM_TAIL


def test_flagless_instances_compare_with_a_first_version_before_the_flag(
        scripts):
    """SASS is compared by kernel name: an instance without the window flag
    is held to the flagless name where the first version predates it, and
    to its own name otherwise."""
    ab = scripts("flash_ab")
    new = "_ZN5_anon_18flash_wgmma_kernelILi128ELb0EEEvNS_10HopperMapsE"
    old = "_ZN5_anon_18flash_wgmma_kernelILi128EEEvNS_10HopperMapsE"
    assert ab.first_name(new, {old: ""}) == old
    assert ab.first_name(new, {new: ""}) == new
    windowed = new.replace("Lb0E", "Lb1E")
    assert ab.first_name(windowed, {old: ""}) not in {old: ""}


@pytest.mark.parametrize("script", ["p2m_ab", "flash_ab", "slstm_ab"])
def test_without_sources_it_prints_usage_and_fails(capsys, scripts, script):
    assert scripts(script).main([]) == 1
    assert "usage" in capsys.readouterr().err


def test_rglru_ab_binds_versions_with_and_without_the_gated_entry(scripts):
    """A version from before the gated instance binds ``rglru_scan`` alone;
    a newer one both entries; without a card the script exits 1."""
    import types
    ab = scripts("rglru_ab")
    old = types.SimpleNamespace(rglru_scan=types.SimpleNamespace())
    new = types.SimpleNamespace(rglru_scan=types.SimpleNamespace(),
                                rglru_scan_gated=types.SimpleNamespace())
    assert ab.bind(old) is False and len(old.rglru_scan.argtypes) == 7
    assert ab.bind(new) is True
    assert len(new.rglru_scan_gated.argtypes) == 11
    assert ab.main(["a.cu"]) == 1


def test_slstm_ab_geometries_are_chip_smokes(scripts):
    ab = scripts("slstm_ab")
    geoms = ab.geometries()          # puts the checkout's root on the path
    import chip_smoke as cs
    assert geoms == {"serving": cs.SLSTM_SERVING, "f32_dh256": cs.SLSTM_F32,
                     "narrow": cs.SLSTM_NARROW}
    assert geoms["serving"] == dict(batch=4, seq=2048, heads=4, head_dim=256,
                                    w_dtype="bfloat16")
    assert geoms["f32_dh256"] == dict(geoms["serving"], w_dtype="float32")
    assert ab.SOURCE == os.path.join(CSRC, "slstm_scan.cu")
    assert set(ab.EXACT) <= set(ab.DIAGNOSTICS)


def test_slstm_ab_binds_versions_with_and_without_the_design_entry(scripts):
    """A version from before the cluster design binds ``slstm_scan`` alone;
    a newer one its design query too."""
    import types
    ab = scripts("slstm_ab")
    old = types.SimpleNamespace(slstm_scan=types.SimpleNamespace())
    new = types.SimpleNamespace(slstm_scan=types.SimpleNamespace(),
                                slstm_scan_design=types.SimpleNamespace())
    assert ab.bind(old) is False and len(old.slstm_scan.argtypes) == 3
    assert ab.bind(new) is True
    assert len(new.slstm_scan_design.argtypes) == 5


def _chip_smoke_lm_phases():
    """{arch: {path, layers}} of every ``lm_phase`` call in chip_smoke.py's
    ``main``, read from its source (defaults: granite-8b, "lm", 0)."""
    import chip_smoke as cs
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")

    def value(node):
        return getattr(cs, node.id) if isinstance(node, ast.Name) \
            else ast.literal_eval(node)

    out = {}
    for call in ast.walk(main):
        if isinstance(call, ast.Call) and getattr(call.func, "id", "") \
                == "lm_phase":
            pos = [value(a) for a in call.args[2:]]
            kw = {k.arg: value(k.value) for k in call.keywords}
            arch = pos[0] if pos else kw.get("arch", cs.LM_ARCH)
            out[arch] = dict(path=pos[1] if len(pos) > 1
                             else kw.get("path", "lm"),
                             layers=kw.get("layers", 0),
                             **{k: kw[k] for k in ("batch", "prompt")
                                if k in kw})
    return out


@pytest.mark.parametrize("arch", [
    "granite-8b", "stablelm-3b", "recurrentgemma-2b", "deepseek-v2-236b",
    "kimi-k2-1t-a32b", "xlstm-350m", "whisper-base"])
def test_lm_ab_runs_each_arch_as_chip_smoke_does(scripts, arch):
    """lm_ab.py's child runs an arch's LM phase with the path, depth cut
    and shape that chip_smoke.py's own run uses (xlstm-350m: the sLSTM
    kernel's path, so its launch check expects no flash launch;
    whisper-base: its own path, 16 clips and a 224-token prompt)."""
    ab = scripts("lm_ab")
    scripts("ab_versions").import_checkout()
    phases = _chip_smoke_lm_phases()
    assert len(phases) == 7
    assert ab.phase_args(arch) == phases[arch]
    if arch == "xlstm-350m":
        assert ab.phase_args(arch) == dict(path="lm_xlstm", layers=0)
