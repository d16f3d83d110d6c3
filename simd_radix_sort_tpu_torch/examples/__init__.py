"""Worked examples: the operator set composed into query pipelines, on one
card (`query_pipeline`) and across ranks (`distributed_pipeline`).

    python -m simd_radix_sort_tpu_torch.examples.query_pipeline [--device cpu]
    python -m simd_radix_sort_tpu_torch.examples.distributed_pipeline \
        [--ranks P] [--device cpu]
"""
