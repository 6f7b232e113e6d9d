"""The ALS training cell: back-to-back trains through the port's
``models/als.als_train_prepared`` on one prepared layout.

Set-up makes the ratings from the seed, builds the layout with
``als_prepare`` (timed as ``layout_s``) and runs one train, which
uploads the layout and builds the kernels. The window then runs whole
trains, each from its own seeded initial item factors, until
``seconds`` have passed; a train counts once its U and V are on the
host. The check runs the float64 reference over a seeded sample of the
window's trains (see ``check``).
"""

from __future__ import annotations

import contextlib
import time
from unittest import mock

import numpy as np

from benchlib import traffic, work
from benchlib.common import DATA_CACHE, log
from benchlib.tracing import span


class AlsTrainLoop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, clock,
                 control: bool = False) -> None:
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.clock, self.control = clock, control
        self.k = int(cfg["rank"])
        self.iterations = int(cfg["iterations"])
        self.lam = float(cfg["lambda"])

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        import torch  # noqa: F401

        from predictionio_tpu_torch.models import als

        c = self.cfg
        t = time.perf_counter()
        self.users, self.items, self.vals = traffic.ratings(c, self.seed, DATA_CACHE,
                                                           device=self.device)
        self.clock.stage("ratings", t)
        self.coo = als.RatingsCOO(self.users, self.items, self.vals,
                                  c["num_users"], c["num_items"])
        t = time.perf_counter()
        self.prep = als.als_prepare(self.coo)
        self.layout_s = self.clock.stage("layout (als_prepare)", t)
        self.params = als.ALSParams(rank=self.k, iterations=self.iterations,
                                    reg=self.lam, weighted_reg=True, implicit=False)
        t = time.perf_counter()
        self._train(0)
        self.clock.stage("warm-up train (upload, kernels)", t)

    def _guard(self):
        """The control: the program's own TF32 path, its f32 guard taken
        out and TF32 allowed for float32 products."""
        if not self.control:
            return contextlib.nullcontext()
        import torch

        from predictionio_tpu_torch.models import als

        stack = contextlib.ExitStack()
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        stack.callback(torch.set_float32_matmul_precision, prev)
        stack.enter_context(mock.patch.object(als, "full_f32", contextlib.nullcontext))
        return stack

    def _train(self, index: int):
        import torch

        from predictionio_tpu_torch.models.als import als_train_prepared

        with span("init_factors"):
            V0 = traffic.initial_factors(torch, self.cfg["num_items"], self.k, self.seed,
                                         index, self.device)
        with span("als_train_prepared"), self._guard():
            U, V = als_train_prepared(self.prep, self.params, device=self.device, V0=V0)
        return V0, U, V

    # -- the window --------------------------------------------------------------

    def run_window(self, seconds: float) -> None:
        """Whole trains until ``seconds`` have passed. Keeps the last train
        and one earlier train drawn from the seed (a reservoir of one)."""
        rng = np.random.default_rng([self.seed, 4])
        self.kept = {}
        last = None
        n = 0
        t0 = time.perf_counter()
        with span("window"):
            while True:
                out = self._train(n + 1)
                if last is not None and rng.random() < 1.0 / n:
                    self.kept["sampled"] = last
                last = (n,) + out
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        self.window_s = time.perf_counter() - t0
        self.kept["last"] = last
        self.trains = n
        self.nonfinite = sum(not (np.isfinite(t[2]).all() and np.isfinite(t[3]).all())
                             for t in self.kept.values())

    def end_to_end(self) -> dict:
        nnz = len(self.vals)
        return {"train_ratings_per_s": nnz * self.iterations * self.trains / self.window_s}

    @property
    def attempted(self) -> int:
        return self.trains

    @property
    def failed(self) -> int:
        return self.nonfinite

    # -- per-layer context ---------------------------------------------------------

    def layer_context(self) -> dict:
        """The shapes of the window's work for the per-layer readers: model
        FLOPs a train, and the (FLOP, bytes) of each gather_gram and
        chol_solve call a train makes, from the valid ratings and rated
        entities the layout holds (no padding)."""
        k, it = self.k, self.iterations
        cu = np.bincount(self.users, minlength=self.cfg["num_users"])
        ci = np.bincount(self.items, minlength=self.cfg["num_items"])
        gram, solve = [], []
        for side, n_other, counts in ((self.prep.u_side, self.cfg["num_items"], cu),
                                      (self.prep.i_side, self.cfg["num_users"], ci)):
            for b in side.buckets:
                valid = b.mask.reshape(-1, b.C) > 0
                slots = int(valid.sum())
                rows = int(valid.any(axis=1).sum())
                f_rows = int(np.count_nonzero(np.bincount(
                    b.other_idx.reshape(-1, b.C)[valid], minlength=n_other)))
                gram.append(work.gram_call_bound(slots, rows, f_rows, k))
            solve.append(work.solve_call_bound(int(np.count_nonzero(counts)), k))
        return {
            "kind": "als_train",
            "trains": self.trains,
            "model_flops_per_train": work.als_model_flops(
                len(self.vals), int(np.count_nonzero(cu)), int(np.count_nonzero(ci)), k, it),
            "gram_bound_s_per_train": it * work.sum_bounds(gram),
            "solve_bound_s_per_train": it * work.sum_bounds(solve),
            "layout_s": self.layout_s,
        }

    # -- the check -------------------------------------------------------------------

    def release(self) -> None:
        """Free the program's device state before the reference runs."""
        import torch

        self.prep._device_bufs = None
        self.prep = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """For each kept train: its objective against the float64
        reference's after the same iterations from the same initial
        factors (``objective_gap``), and its item factors against the
        float64 solution of their normal equations given its own user
        factors (``v_normal_eq``). The worst over the kept trains."""
        from reference import als as ref_als

        t = time.perf_counter()
        ref = ref_als.Ratings(self.users, self.items, self.vals, self.cfg["num_users"],
                              self.cfg["num_items"], self.device)
        gap = ne = 0.0
        for name, (n, V0, U, V) in self.kept.items():
            Ur, Vr = ref.train(V0, self.iterations, self.lam)
            l_ref = ref.objective(Ur, Vr, self.lam)
            del Ur, Vr
            l_got = ref.objective(U, V, self.lam)
            g = abs(l_got - l_ref) / l_ref
            e = ref_als.normal_equations_err(ref.items, U, V, self.lam)
            log(f"check: train {n} ({name}): objective {l_got!r} against the float64 "
                f"reference's {l_ref!r} (gap {g:.3e}); item factors off their float64 "
                f"normal equations by {e:.3e}")
            gap, ne = max(gap, g if np.isfinite(g) else np.inf), max(ne, e)
        log(f"check: reference took {time.perf_counter() - t:.1f} s")
        lim = self.cfg["checks"]
        return {"objective_gap": (gap, lim["objective_gap"]),
                "v_normal_eq": (ne, lim["v_normal_eq"])}
