"""pointwise_device_ms.fed: pointwise_device_ms.train's reading, in a fed
training cell (one whose rate is ``fed_train_samples_per_s``)."""

import os

from benchmarks.harness import load_metric

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = load_metric("pointwise_device_ms.train", BENCH)
