"""The kernel build's resource-usage report, read from a ptxas log (no
nvcc needed: the log is written here as nvcc would write it), and the
ctypes signatures against the sources' C entries."""
import re
import sys

import pytest
import torch

from zkevm_specs_tpu_torch.runtime import cuda_build

torch.set_num_threads(1)

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem, 64 bytes cmem[3]
ptxas info    : Compiling entry function '_ZN42_GLOBAL__N__20b7434f_12_logup_sum_cu_c_p179up_kernelEPKx' for 'sm_90a'
ptxas info    : Function properties for _ZN42_GLOBAL__N__20b7434f_12_logup_sum_cu_c_p179up_kernelEPKx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 0 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120mul_add_words_kernelILi512EEEvPKx' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120mul_add_words_kernelILi512EEEvPKx
    152 bytes stack frame, 152 bytes spill stores, 160 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for _Z9helper_fnPj
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_113fr_inv_kernelEPKxxiPxx", "fr_inv_kernel"),
    ("_ZN38_GLOBAL__N__adcf131a_9_fr_mul_cu_c_p1713fr_mul_kernelEPKxxiS1_xiPxx",
     "fr_mul_kernel"),
    ("_ZN42_GLOBAL__N__20b7434f_12_logup_sum_cu_c_p179up_kernelEPKx", "up_kernel"),
    ("_ZN12_GLOBAL__N_120mul_add_words_kernelILi256EEEvPKx", "mul_add_words_kernel<256>"),
    ("_ZN12_GLOBAL__N_118limb_addsub_kernelILi2ELi17ELb1EEEvNS_4ArgsE",
     "limb_addsub_kernel<2, 17, true>"),
    ("_ZN12_GLOBAL__N_123lookup_gather_eq_kernelILb0EEEvNS_5PartsE",
     "lookup_gather_eq_kernel<false>"),
    ("_Z13fr_mul_kernelPKxxiS0_xiPxx", "fr_mul_kernel"),
    ("not_mangled", "not_mangled"),
])
def test_kernel_name(mangled, name):
    assert cuda_build._kernel_name(mangled) == name


def test_resource_usage_reads_the_ptxas_log(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    assert cuda_build.resource_usage("logup_sum") == {}
    cuda_build._so_path("logup_sum").with_suffix(".log").write_text(PTXAS_LOG)
    assert cuda_build.resource_usage("logup_sum") == {
        "up_kernel": {"stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
                      "registers": 122},
        "mul_add_words_kernel<512>": {"stack_bytes": 152, "spill_store_bytes": 152,
                                      "spill_load_bytes": 160, "registers": 255},
    }


def test_build_asks_ptxas_for_its_report():
    assert cuda_build.NVCC_FLAGS[-2:] == ["-Xptxas", "-v"]


ENTRIES = [(lib, fn) for lib, fns in cuda_build.SIGNATURES.items() for fn in fns]


@pytest.mark.parametrize("lib,fn", ENTRIES)
def test_signature_matches_the_source(lib, fn):
    """Each C entry's parameters in its source, one ctypes type each."""
    source = (cuda_build.CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", source)
    assert m, f"{fn} is not an extern \"C\" int entry of {lib}.cu"
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(cuda_build.SIGNATURES[lib][fn])


def test_variants_build_with_their_defines_and_launch_only_inside_launching(tmp_path,
                                                                          monkeypatch):
    """``build_variants`` runs one compiler a variant with its ``-D`` flags
    into a library of its own; ``launching`` hands one to the wrappers for
    the block and then gives back the source's own build."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write(' '.join(sys.argv))\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "_load", lambda name, so: (name, so.read_text()))
    monkeypatch.setitem(cuda_build._LIBS, "keccak_sponge", "own")
    libs = cuda_build.build_variants("keccak_sponge", {"row": ["KECCAK_COOP_ROWS=0"],
                                                       "warp": ["KECCAK_COOP_ROWS=7", "X=1"]})
    assert "-DKECCAK_COOP_ROWS=0" in libs["row"][1].split()
    assert {"-DKECCAK_COOP_ROWS=7", "-DX=1"} <= set(libs["warp"][1].split())
    assert all(str(cuda_build.CSRC / "keccak_sponge.cu") in cmd for _, cmd in libs.values())
    assert len(set(tmp_path.joinpath("kernels").glob("*.so"))) == 2
    with cuda_build.launching("keccak_sponge", libs["row"]):
        assert cuda_build.library("keccak_sponge") is libs["row"]
    assert cuda_build.library("keccak_sponge") == "own"


def test_path_taken_names_the_path_whose_count_moved(monkeypatch):
    """``path_taken`` returns the one path whose launch count, as the C
    entry reports it, moved across the call; a call that launched none
    raises."""
    counts = {"row": 3, "warp": 5}

    class Lib:
        @staticmethod
        def keccak_sponge_path_launches(*refs):
            for ref, path in zip(refs, cuda_build.PATHS["keccak_sponge"]):
                ref._obj.value = counts[path]

    def launch(path):
        counts[path] += 1

    monkeypatch.setitem(cuda_build._LIBS, "keccak_sponge", Lib())
    assert cuda_build.path_launches("keccak_sponge") == counts
    assert cuda_build.path_taken("keccak_sponge", lambda: launch("warp")) == "warp"
    assert cuda_build.path_taken("keccak_sponge", lambda: launch("row")) == "row"
    with pytest.raises(ValueError):
        cuda_build.path_taken("keccak_sponge", lambda: None)
