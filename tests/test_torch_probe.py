"""The kernel probes' parts that need no card: the SASS loop count, the
source substitutions, the exchange cases and the round timings' specs
(``repro_torch.launch.fused_probe``, ``wkv6_probe``, ``round_timing``,
``serial_probe``, ``exchange_probe``)."""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import RunSpec  # noqa: E402
from repro_torch.launch import exchange_probe as xp  # noqa: E402
from repro_torch.launch import fused_probe as fp  # noqa: E402
from repro_torch.launch import round_timing as rt  # noqa: E402
from repro_torch.launch import serial_probe as sp  # noqa: E402
from repro_torch.launch import wkv6_probe as wp  # noqa: E402


def _insn(addr: int, text: str) -> str:
    return f"        /*{addr:04x}*/                   {text} ;  /* 0x000000000000 */\n"


def _sass(name: str, body: list[str], outer: bool) -> str:
    """A kernel whose inner loop is ``body`` (once per hash: 19 rotates),
    inside an outer loop that hashes once more when ``outer``."""
    lines, addr = [f"\t\tFunction : _ZN12_GLOBAL__N_1{len(name)}{name}EPKa\n"], 0
    for text in ["LDC R1, c[0x0][0x28]"] + (["SHF.L.W.U32.HI R9, R8, 0xd, R8"] * 19 if outer else []):
        lines.append(_insn(addr, text))
        addr += 16
    inner = addr
    for text in body:
        lines.append(_insn(addr, text))
        addr += 16
    lines.append(_insn(addr, f"@!P0 BRA 0x{inner:x}"))
    addr += 16
    lines.append(_insn(addr, "@P1 BRA 0x0"))
    lines.append(_insn(addr + 16, "EXIT"))
    return "".join(lines)


HASH = ["SHF.L.W.U32.HI R5, R4, 0xd, R4", "LOP3.LUT R5, R5, R6, RZ, 0x3c, !PT",
        "IMAD.IADD R6, R6, 0x1, R5"]


@pytest.mark.parametrize("outer", [False, True])
def test_sass_loops_counts_the_innermost_hashing_loop(outer):
    body = HASH * 19 * 2 + ["LDS.U8 R7, [R3]", "ISETP.GE.AND P0, PT, R3, R2, PT",
                            "I2FP.F32.U32 R8, R7", "VIADD R3, R3, 0x2"]
    text = _sass("ising_fused_kernel", body, outer) + _sass("other_kernel", HASH * 19, False)
    (loop,) = fp.sass_loops(text, "ising_fused")
    assert loop["rotates"] == 38 and loop["hashes"] == 2
    assert len(loop["ops"]) == len(body) + 1  # the backward branch too
    assert loop["classes"] == {"alu": 19 * 2 * 2 + 1, "fma": 38, "shared": 1,
                               "conversion": 1, "other": 1, "branch": 1}
    assert loop["opcodes"]["SHF"] == 38 and loop["opcodes"]["VIADD"] == 1


def test_sass_loops_counts_what_an_enclosing_loop_adds_around_the_hashes():
    """#2p's innermost hashing loop is one replica's pass over a run; the run
    loop around it adds the site's shared loads, adder and store."""
    shared = ["LDS.U8 R7, [R3]"] * 5 + ["LOP3.LUT R5, R5, R6, RZ, 0x3c, !PT"] * 4
    lines = [f"\t\tFunction : _ZN12_GLOBAL__N_119ising_packed_kernelEPKa\n"]
    addr = 0
    for text in shared:
        lines.append(_insn(addr, text))
        addr += 16
    inner = addr
    for text in HASH * 19:
        lines.append(_insn(addr, text))
        addr += 16
    lines.append(_insn(addr, f"@!P0 BRA 0x{inner:x}"))
    lines.append(_insn(addr + 16, "STS.U8 [R3], R5"))
    lines.append(_insn(addr + 32, "@!P1 BRA 0x0"))
    lines.append(_insn(addr + 48, "EXIT"))
    (loop,) = fp.sass_loops("".join(lines), "ising_packed")
    assert loop["hashes"] == 1 and len(loop["ops"]) == 3 * 19 + 1
    assert loop["outside"] == len(shared) + 2  # the store and the outer branch


def test_sass_loops_skips_loops_without_a_hash_and_other_kernels():
    text = _sass("potts_fused_kernel", ["LDS.U8 R7, [R3]"] * 4, False)
    assert fp.sass_loops(text, "potts_fused") == []
    assert fp.sass_loops(_sass("ising_fused_kernel", HASH * 19, False), "potts_fused") == []


def test_build_variant_refuses_a_source_without_the_constant(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "ising_fused.cu").write_text("constexpr int kThreads = 512;\n")
    with pytest.raises(ValueError, match="kSites"):
        fp.build_variant(csrc, "ising_fused", tmp_path / "out", threads=256, sites=4)
    text = (tmp_path / "out" / "src" / "ising_fused.cu").read_text()
    assert text == "constexpr int kThreads = 512;\n"  # nothing written on refusal


def test_package_kernels_carry_the_constants_the_probe_substitutes():
    csrc = Path(fp.build.CSRC)
    assert set(fp.KERNELS) == {"ising_fused", "potts_fused", "ising_packed"}
    for name in fp.KERNELS:
        text = (csrc / f"{name}.cu").read_text()
        assert text.count("constexpr int kThreads = ") == 1
        assert text.count("constexpr int kSites = ") == 1


@pytest.mark.parametrize("rows,cols", [(16, 1), (8, 4), (4, 8)])
def test_wkv6_probe_substitutes_the_package_tile(rows, cols):
    text = (Path(fp.build.CSRC) / "wkv6.cu").read_text()
    assert text.count("constexpr int kRows = ") == 1 and text.count("constexpr int kCols = ") == 1
    out = wp.substitute(text, rows, cols)
    assert f"constexpr int kRows = {rows};" in out and f"constexpr int kCols = {cols};" in out
    assert len(out.splitlines()) == len(text.splitlines())


def test_wkv6_probe_refuses_a_source_without_the_tile():
    with pytest.raises(ValueError, match="kCols"):
        wp.substitute("constexpr int kRows = 16;\n", 8, 4)


def test_exchange_cases_cover_both_pairings_criteria_and_eight_phases():
    cases = list(fp.exchange_cases("cpu", r=40))
    assert len(cases) == 32
    assert {(c["pairing"], c["criterion"], c["phase"]) for c in cases} == {
        (p, c, k) for p in ("deo", "seo") for c in ("logistic", "metropolis") for k in range(8)}
    for c in cases:
        assert sorted(c["rung"].tolist()) == list(range(40))
        assert c["energy"].dtype == c["de"].dtype == c["betas"].dtype == torch.float32
        assert int(c["ph0"]) == 1000 + c["phase"]
        # rung order is near an equilibrated ladder: neighbours 100 apart, +-400
        by_rung = torch.empty_like(c["energy"])
        by_rung[c["rung"].long()] = c["energy"]
        assert bool(((by_rung[1:] - by_rung[:-1]).abs() < 1000).all())


def test_split_tells_a_csrc_whose_rounds_are_two_launches(tmp_path):
    assert not fp._split(Path(fp.build.CSRC))
    (tmp_path / "exchange.cu").write_text("// kernel B\n")
    assert fp._split(tmp_path)


@pytest.mark.parametrize("name", sorted(rt.CONFIGS))
def test_round_timing_specs_are_round_path_specs(name):
    spec = rt.make_spec(name)
    assert RunSpec.from_json(spec.to_json()) == spec
    params = spec.system.params
    assert params["use_fused"] and params["use_fused_round"]
    assert spec.ladder.n_replicas == 1500
    assert spec.schedule.total_sweeps == spec.engine.swap_interval * rt.CONFIGS[name][3]


@pytest.mark.parametrize("edits", [*sp.VARIANTS.values(), sp.STAGE_CLOCKS],
                         ids=[*sp.VARIANTS, "stage clocks"])
def test_serial_probe_edits_apply_once_to_the_package_source(edits):
    from repro_torch.kernels import build

    text = (build.CSRC / "serial_chain.cu").read_text()
    out = sp.substitute(text, edits)
    assert out != text and all(new in out for _, new in edits)


def test_serial_probe_refuses_an_edit_that_does_not_match():
    with pytest.raises(ValueError, match="not exactly one"):
        sp.substitute("int a; int a;", [("int a;", "int b;")])


@pytest.mark.parametrize("edits", xp.VARIANTS.values(), ids=list(xp.VARIANTS))
def test_exchange_probe_edits_apply_once_to_the_package_source(edits):
    from repro_torch.kernels import build

    text = (build.CSRC / "exchange_step.cu").read_text()
    out = xp.substitute(text, edits)
    assert out != text and all(new in out for _, new in edits)


@pytest.mark.parametrize("name", list(xp.MESH_CONFIGS))
@pytest.mark.parametrize("mesh", [False, True])
def test_exchange_probe_specs_are_round_path_specs(name, mesh):
    side, interval, n_int = xp.MESH_CONFIGS[name]
    spec = RunSpec.from_json(xp.mesh_spec(side, interval, n_int, mesh))
    assert spec.system.params["use_fused_round"] and spec.ladder.n_replicas == xp.ROWS
    assert spec.schedule.total_sweeps == interval * n_int
    assert (spec.engine.mesh is not None) == mesh
