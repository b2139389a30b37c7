"""The benchmark of the PyTorch and CUDA port (``repro_torch``):
``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. See README.md."""
