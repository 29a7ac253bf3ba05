"""The benchmark of ``ccvs_tpu_torch`` on one H100: run one cell with
``python3 ccvs_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout."""
