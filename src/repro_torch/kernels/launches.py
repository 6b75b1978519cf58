"""Launch counts of the port's kernels: each wrapper adds one to its
entry where it launches its kernel, and nowhere else, so a run can show
that it went through the kernels."""

LAUNCHES = {"region_aggregate": 0, "ranl_update": 0, "flash_attention": 0,
            "rwkv_wkv": 0, "chol_update": 0, "flash_attention_bwd": 0,
            "rwkv_wkv_bwd": 0, "masked_aggregate": 0, "grouped_matmul": 0,
            "grouped_matmul_bwd": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
