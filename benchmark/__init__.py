"""The benchmark of the PyTorch/CUDA port (`simd_radix_sort_tpu_torch`).

One command runs one cell of `BENCHMARK.json` once, on the machine it is
started on:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric or
operation sits in a file of its own, found by the name `BENCHMARK.json`
gives it:

    configs/<config>.json     the configuration's sizes, source and limits
    configs/<config>.py       its data, made on the card from the seed, and
                              its operations: the timed path, through the
                              port's public entry points
    reference/<config>.py     the plain reference (NumPy or plain torch; it
                              imports nothing of the port)
    traffic/<mix>.json        the mix's parameters, read by calls.py
    metrics/<metric>.py       a reader of one metric over a run's record
    work/<operation>.py       the bytes one operation needs

Nothing here imports `jax` or the JAX package `simd_radix_sort_tpu`, and a
run that finds either loaded refuses to print a result (guard.py).
"""
