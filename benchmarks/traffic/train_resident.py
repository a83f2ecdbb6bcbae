"""Training on batches already on the card: token rows drawn from the
seed on the device at set-up, one batch a step from a pool of distinct
batches, steps dispatched back to back, the loss fetched every
``loss_every`` steps as a training loop logs it."""

from __future__ import annotations

import torch

from ..harness import sub_seed
from ..training import TrainDriver


class Driver(TrainDriver):
    def start_data(self) -> None:
        p, dev = self.p, self.run.device
        vocab = self.cell.family.sizes(self.cell.config)["real_vocab"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(sub_seed(self.run.seed, "tokens"))
        rows = torch.randint(0, vocab, (p["pool_batches"], p["batch"],
                                        p["seq"] + 1),
                             generator=gen, device=dev)
        self.inputs = rows[..., :-1].contiguous()
        self.targets = rows[..., 1:].contiguous()
        self.served = 0

    def next_batch(self):
        k = self.served % self.inputs.shape[0]
        self.served += 1
        return self.inputs[k], self.targets[k]

    def reference_batch(self, k: int):
        return self.inputs[k], self.targets[k]
