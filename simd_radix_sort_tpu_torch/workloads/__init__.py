"""The north-star workload scripts on the card.

Counterparts of the JAX repository's scripts: `headline` (bench.py),
`combined_1e8` (scripts/combined_1e8.py, configuration 3), `pipeline_1e9`
(scripts/pipeline_1e9.py, configuration 4) and `config5_scale`
(scripts/config5_scale.py, configuration 5), with their shared helpers in
`common` (scripts/benchlib.py); and the measurement campaign's drivers
`perf_suite`, `knob_epoch`, `remeasure_noise` and `run_test_matrix` (the
scripts of the same names), with `campaign`, which runs them on the card
into bench_out_h100/.  Each has a `main(argv=None)` for

    python -m simd_radix_sort_tpu_torch.workloads.<name> [options]

and functions on tensors that take `device=None`, meaning CUDA (raising
without a card unless the caller passes device="cpu").
"""
