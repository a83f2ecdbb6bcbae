"""Training fed by the program's Data layer: a ``from_numpy`` Dataset of
images and labels made from the seed at set-up (``zip`` of two columns,
under local mode), read epoch after epoch through
``iter_torch_batches(device=..., device_prefetch=...)``, each batch
straight into the train step. The comparison also holds the batches the
feed delivered (the compared steps' and a sample of the window's) to the
host rows the harness made."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..harness import sub_seed
from ..training import TrainDriver


class Driver(TrainDriver):
    # A fed step waits on the host's copies, so its rate spreads more than
    # a resident one's and is held to a bound of its own.
    RATE = "fed_train_samples_per_s"

    def start_data(self) -> None:
        from ray_tpu_torch import data

        p, dev = self.p, self.run.device
        s = self.cell.family.sizes(self.cell.config)
        n, img = int(p["images"]), s["image"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(sub_seed(self.run.seed, "images"))
        images = torch.randn((n, img, img, s["channels"]), generator=gen,
                             device=dev)
        labels = torch.randint(0, s["classes"], (n,), generator=gen,
                               device=dev)
        self.images = images.cpu().numpy()
        self.labels = labels.cpu().numpy()
        del images, labels
        blocks = int(p["blocks"])
        self.dataset = data.from_numpy(
            self.images, "image", override_num_blocks=blocks).zip(
            data.from_numpy(self.labels, "label",
                            override_num_blocks=blocks))
        self.per_epoch = n // int(p["batch"])
        rng = np.random.default_rng(sub_seed(self.run.seed, "feed_check"))
        # Window steps whose delivered batch is held to the host rows.
        self.checked = set(int(x) for x in rng.choice(
            np.arange(self.compared, self.compared + int(p["check_within"])),
            size=int(p["checked_batches"]), replace=False))
        self.checked.update(range(self.compared))
        self.held: Dict[int, tuple] = {}
        self.served = 0
        self.iterator = None

    def _epoch(self):
        return iter(self.dataset.iter_torch_batches(
            batch_size=int(self.p["batch"]), drop_last=True,
            device=self.run.device,
            device_prefetch=int(self.p["device_prefetch"])))

    def next_batch(self):
        with self.run.spans.span("bench.feed_next"):
            if self.iterator is None:
                self.iterator = self._epoch()
            try:
                batch = next(self.iterator)
            except StopIteration:
                self.iterator = self._epoch()
                batch = next(self.iterator)
        pair = batch["image"], batch["label"]
        if self.served in self.checked:
            self.held[self.served] = pair
        self.served += 1
        return pair

    def _rows(self, step: int) -> slice:
        b = int(self.p["batch"])
        k = step % self.per_epoch
        return slice(k * b, (k + 1) * b)

    def reference_batch(self, k: int):
        rows, dev = self._rows(k), self.run.device
        return (torch.from_numpy(self.images[rows]).to(dev),
                torch.from_numpy(self.labels[rows]).to(dev))

    def release(self) -> None:
        self.iterator = None
        super().release()

    def extra_numbers(self) -> Dict[str, float]:
        """``feed_mismatch``: the delivered batches held (the compared
        steps' and a sample of the window's) that differ from the host
        rows by a single bit or in shape."""
        bad = 0
        for step, (image, label) in self.held.items():
            rows = self._rows(step)
            want_i = torch.from_numpy(self.images[rows])
            want_l = torch.from_numpy(self.labels[rows])
            got_i, got_l = image.cpu(), label.cpu()
            same = (got_i.shape == want_i.shape and got_l.shape ==
                    want_l.shape and torch.equal(got_i, want_i)
                    and torch.equal(got_l.long(), want_l.long()))
            bad += not same
        self.held.clear()
        return {"feed_mismatch": float(bad)}
