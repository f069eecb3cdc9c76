"""What the entries share: a pool of books made on the device from the
seed at set-up, a timed call that prices one book and brings its fields to
the host, and the comparison of sampled books with the plain reference.

An entry subclasses :class:`BookCell` with ``fields``, ``price`` (the
port's call) and ``reference`` (the plain reference, in ``float64`` or in
the control's ``bfloat16``)."""

from __future__ import annotations

import torch

from . import check, generate


class BookCell:
    fields: tuple = ()
    kernel: str | None = None

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.pool = generate.pool(traffic["book"], traffic["pool"], seed, self.device, self.dtype)
        self.work_per_call = generate.book_size(traffic["book"])

    # -- the port ----------------------------------------------------------
    def price(self, book: dict) -> dict:
        """The port's call on one book: ``{field: (B,) tensor}``."""
        raise NotImplementedError

    def call(self, k: int) -> dict:
        """Price pool book ``k`` and bring its fields to the host."""
        out = self.price(self.pool[k])
        host = torch.stack([out[f] for f in self.fields]).cpu()
        return dict(zip(self.fields, host))

    def warm(self) -> None:
        """Run every book of the pool once: every shape the window uses."""
        for k in range(len(self.pool)):
            self.call(k)

    @property
    def shapes(self) -> dict:
        return {}

    # -- the reference -----------------------------------------------------
    def reference(self, book: dict, dtype) -> dict:
        raise NotImplementedError

    def numbers(self, outs: dict) -> dict:
        """``<field>_gap`` over the books ``outs`` ({pool index: the
        program's host fields}), each against the float64 reference."""
        return check.widest([check.gaps(out, self.reference(self.pool[k], torch.float64),
                                        self.pool[k]["K"], self.fields)
                             for k, out in outs.items()])

    def check(self, kept: dict) -> dict:
        """The numbers of the run: the books drawn from the seed among those
        the window priced (each as its last call returned it)."""
        picks = check.sample(list(kept), self.traffic["check_books"], self.seed)
        return self.numbers({k: kept[k] for k in picks})

    def control(self, ks) -> dict:
        """The control's numbers on books ``ks``: the reference computed in
        bfloat16 in the program's place."""
        return check.widest([check.gaps(self.reference(self.pool[k], torch.bfloat16),
                                        self.reference(self.pool[k], torch.float64),
                                        self.pool[k]["K"], self.fields) for k in ks])
