"""``elementwise_ms.train``'s reading, in the SSM training cells: the host
paces their steps and spreads them wider from run to run than the card does,
so the reading moves an end-to-end metric of their own, with a bound of its
own."""

from pathlib import Path

from bench.common.cell import load_file

read = load_file(Path(__file__).with_name("elementwise_ms.train.py"),
                 "bench_metric_elementwise_ms_train").read
