"""attn_roofline.fed: attn_roofline.train's reading, in a fed training cell (one whose
rate is ``fed_train_samples_per_s``)."""

import os

from benchmarks.harness import load_metric

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = load_metric("attn_roofline.train", BENCH)
