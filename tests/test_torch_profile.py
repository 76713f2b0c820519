"""The profilers' classes of the port's kernels, by kernel name, on the CPU.

`tools/profile_sampler.classify` (which `tools/profile_train.py` shares)
files each kernel of the port under its K number, its bf16, f32 and wide
instances alike, from the name the trace gives it (demangled; the mangled
form too). K3's and K7's f32 forward is one kernel under two policies, as
are K4's and K8's f32 backwards, and K5's and K6's f32 launches of the one
SIMT GEMM carry their caller's tag. This file imports no JAX.
"""

import pytest

from small_vision_tpu_torch.tools.profile_sampler import classify

GEMM_GELU = ("void simt_f32::gemm_f32_kernel<(simt_f32::Epilogue)1, "
             "simt_f32::FusedMlp>(simt_f32::GemmArgs)")

NAMES = [
    ("void ln_modulate_fwd_kernel<2, 3>(Params)", "K1 ln_modulate_fwd"),
    ("void ln_modulate_fwd_any_kernel<float, 4, 1>(AnyParams)",
     "K1 ln_modulate_fwd"),
    ("void ln_modulate_bwd_any_kernel<float, 4, 1>(BwdParams)",
     "K2 ln_modulate_bwd"),
    ("void attention_packed_wide_kernel<sm90::ClampExp2>(WideParams)",
     "K3 attention_packed_fwd"),
    ("void f32x3::attn_f32x3_fwd_kernel<f32x3::ClampExp2, 56>"
     "(f32x3::FwdArgs)", "K3 attention_packed_fwd"),
    ("_ZN5f32x321attn_f32x3_fwd_kernelINS_9ClampExp2ELi40EEEvNS_7FwdArgsE",
     "K3 attention_packed_fwd"),
    ("void attn_bwd_wide_dq<false>(WideBwdParams)", "K4 attention_packed_bwd"),
    ("void f32x3::attn_f32x3_stats_kernel<f32x3::ClampExp2, 56>"
     "(f32x3::Args)", "K4 attention_packed_bwd"),
    ("void f32x3::attn_f32x3_dkdv_kernel<f32x3::ClampExp2, 40>"
     "(f32x3::Args)", "K4 attention_packed_bwd"),
    (GEMM_GELU, "K5 fused_mlp_fwd"),
    ("_ZN8simt_f3215gemm_f32_kernelILNS_8EpilogueE1ENS_8FusedMlpEEEvNS_8Gemm"
     "ArgsE", "K5 fused_mlp_fwd"),
    ("_ZN8simt_f3215gemm_f32_kernelILNS_8EpilogueE0ENS_8FusedMhaEEEvNS_8Gemm"
     "ArgsE", "K6 fused_mha_fwd"),
    ("void f32x3::attn_f32x3_dkdv_kernel<f32x3::MaxShift, 56>(f32x3::Args)",
     "K8 attention_unpacked_bwd"),
    ("void attn_bwd_wide_rows<false>(WideBwdParams)",
     "K4 attention_packed_bwd"),
    ("void simt_f32::attn_f32_fwd_kernel<f32x3::MaxShift>(float const*, "
     "float const*, float const*, float*, int, int, int, int, int, float)",
     "K6 fused_mha_fwd"),
    ("void fused_mha_attn_wide_kernel<sm90::MaxShift>(WideParams)",
     "K6 fused_mha_fwd"),
    ("void attention_unpacked_wide_kernel<sm90::MaxShift>(WideParams)",
     "K7 attention_unpacked_fwd"),
    ("void f32x3::attn_f32x3_fwd_kernel<f32x3::MaxShift, 56>"
     "(f32x3::FwdArgs)", "K7 attention_unpacked_fwd"),
    ("void attn_bwd_wide_dkdv<true>(WideBwdParams)",
     "K8 attention_unpacked_bwd"),
    ("_ZN5f32x319attn_f32x3_dq_kernelINS_8MaxShiftELi56EEEvNS_4ArgsE",
     "K8 attention_unpacked_bwd"),
    ("void attention_ablate_wide_kernel<sm90::Prod>(WideParams)",
     "K9 attention_ablate"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor>()",
     "other"),
]


@pytest.mark.parametrize("name,cls", NAMES)
def test_classify_files_each_kernel_under_its_class(name, cls):
  assert classify(name) == cls


@pytest.mark.parametrize("epilogue,caller,cls", [
    (1, "FusedMlp", "K5 fused_mlp_fwd"), (0, "FusedMlp", "K5 fused_mlp_fwd"),
    (0, "FusedMha", "K6 fused_mha_fwd")])
def test_classify_tells_the_f32_projections_apart(epilogue, caller, cls):
  """K5's up- and down-projections and K6's projections launch one GEMM
  under their caller's tag: the tag decides, not the epilogue."""
  name = (f"void simt_f32::gemm_f32_kernel<(simt_f32::Epilogue){epilogue}, "
          f"simt_f32::{caller}>(simt_f32::GemmArgs)")
  assert classify(name) == cls
