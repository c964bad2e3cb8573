"""The kernel build's resource-usage report, read from a ptxas log (no
nvcc needed: the log is written here as nvcc would write it)."""
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
