"""The benchmark of the PyTorch and CUDA port (cmsbwt_tpu_torch): one cell
run once by ``python portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See harness.py."""
