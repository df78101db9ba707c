"""profile_torch.py's bookkeeping: kernel names into groups, and the
busy time as the union of the device events' intervals."""

import profile_torch as pt


def _kernel(name, ts=0.0, dur=1.0, cat="kernel"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


def test_kernel_names_fall_into_their_groups():
    cases = {
        "void (anonymous namespace)::fgh_kernel<64, 3, true>(float const*, float*, int)":
            "fgh kernel (B1)",
        "(anonymous namespace)::cg_kernel(float const*, float*, int)": "cg kernel (B2)",
        "void (anonymous namespace)::ls_kernel<64, 3>(float const*, float*, int)":
            "ls kernel (B3)",
        "void (anonymous namespace)::newton_kernel<64, 3, true, false>(float const*, int)":
            "newton kernel (B4 and B5)",
        "void potrf_cta_lower_batch<float, float, 16>(int, int)": "Cholesky / cholesky_inverse",
        "void trsm_template_batched_lNL_kernel<float, 16, 16>(magma_diag_t)":
            "Cholesky / cholesky_inverse",
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8": "gemm / bmm (cuBLAS)",
        "void at::native::indexFuncLargeIndex<float, long>": "gather / scatter / index",
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>":
            "reductions",
        "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>": pt.OTHER,
    }
    for name, group in cases.items():
        assert pt.group_of(_kernel(name)) == group, name
    assert pt.group_of(_kernel("Memcpy HtoD", cat="gpu_memcpy")) == pt.COPIES
    # newton_bf16_beta's instantiations, apart from the float32 beta_doc's
    beta = {
        "void (anonymous namespace)::fgh_kernel<64, 3, true, __nv_bfloat16, true, 1>(float "
        "const*, __nv_bfloat16 const*)": "fgh kernel (B1), bf16 beta_doc",
        "void (anonymous namespace)::ls_kernel<64, 3, __nv_bfloat16, true, 2>(float const*)":
            "ls kernel (B3), bf16 beta_doc",
        "void (anonymous namespace)::newton_kernel<64, 3, true, false, __nv_bfloat16>(int)":
            "newton kernel (B4 and B5), bf16 beta_doc",
    }
    for name, group in beta.items():
        assert pt.group_of(_kernel(name)) == group, name


def test_busy_time_counts_overlaps_once():
    events = [_kernel("a", 0, 10), _kernel("b", 5, 10), _kernel("c", 30, 5),
              _kernel("d", 31, 1)]
    assert pt.busy_us(events) == 20.0
    assert pt.busy_us([]) == 0.0


def test_options_parse():
    args = pt.parse_args([])
    assert args.trace == "build/profile/em_iter_trace.json" and not args.bf16_beta
    args = pt.parse_args(["--bf16-beta", "--trace", "out/t.json"])
    assert args.bf16_beta and args.trace == "out/t.json"
