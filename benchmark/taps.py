"""What the port computes inside its programs, kept for the check.

Each tap stands in for one name in one of the port's modules and calls
the real object behind it, so that the same function computes the same
result on the same tensors; it only keeps references (and, for the
L-BFGS state, which the step updates in place, a copy).

* :class:`StepTap`: ``lbfgs_step`` in ``transfer/nst.py``, which the NST
  loop calls once a closure, and ``cached_nst_program`` in the main, whose
  NST program it wraps to see the content each call starts from.  For one
  armed NST call (the batch the check samples) it follows the iterate as
  the loop is meant to move it (x clamped to [0, 1] at each closure's
  start, then x + the update the step returned), and keeps, at chosen
  closures, that x, the gradient, the optimizer's state as it came in, and
  the update that went out.  The check holds the NST's output to the
  iterate so followed, and the gradient to the reference's at that x.
* :class:`ApplyTap`: a model's class in one of the port's modules, whose
  ``apply`` the programs call (``RITnet`` in the 2019 main, ``EfficientNet``
  in the 2020 main, ``ResNet50`` in ``models/gaze.py``); while a recorder
  keeps outputs it keeps what each call returns (labels, features).
"""

from __future__ import annotations

import importlib


class ApplyTap:
    def __init__(self, module: str, name: str, rec):
        self.module = importlib.import_module(module)
        self.name = name
        self.real = getattr(self.module, name)
        self.rec = rec
        self.labels: list = []
        setattr(self.module, name, self)

    def apply(self, *args, **kw):
        out = self.real.apply(*args, **kw)
        if self.rec.keeping:
            self.labels.append(out)
        return out

    def take(self):
        """What was kept since the last take, in call order."""
        import torch

        out, self.labels = torch.cat(self.labels), []
        return out

    def close(self) -> None:
        setattr(self.module, self.name, self.real)


class StepTap:
    def __init__(self, main: str):
        # the module itself: the package's ``nst`` attribute is its function
        nst = importlib.import_module("iris_style_transfer_tpu_torch.transfer.nst")
        self.nst = nst
        self.real = nst.lbfgs_step
        self.main = importlib.import_module(main)
        self.real_program = self.main.cached_nst_program
        self.calls = -1
        self.target = None
        self.want: set[int] = set()
        self.records: dict[int, dict] = {}
        self.content = None  # the content image of the NST call under way
        self.x = None  # the armed call's iterate, followed from its updates

    def __enter__(self):
        self.nst.lbfgs_step = self
        self.main.cached_nst_program = self.program
        return self

    def __exit__(self, *exc):
        self.nst.lbfgs_step = self.real
        self.main.cached_nst_program = self.real_program

    def program(self, *args, **kw):
        fn = self.real_program(*args, **kw)

        def run(vgg_params, c_img, *rest, **kws):
            self.content = c_img
            try:
                return fn(vgg_params, c_img, *rest, **kws)
            finally:
                self.content = None

        return run

    def arm(self, call: int | None, closures=()) -> None:
        """Keep closures ``closures`` of NST call number ``call`` (from 0)."""
        self.calls, self.target, self.want, self.records, self.x = -1, call, set(closures), {}, None

    def __call__(self, state, g, lr=1.0, method="compact", group=None):
        k = state.iteration
        if k == 0:
            self.calls += 1
            if self.calls == self.target:  # the loop's x = c_img.float().clone()
                self.x = self.content.float().clone()
        follow = self.calls == self.target and self.x is not None
        if follow:
            self.x = self.x.clamp(0.0, 1.0)
        keep = follow and k in self.want
        if keep:
            rec = {"x": self.x, "g": g.detach().float().clone(), "lr": lr, "iteration": k}
            if k > 0:
                rec.update(prev_g=state.prev_g.clone(), prev_step=state.prev_step.clone(),
                           s_hist=state.s_hist.clone(), y_hist=state.y_hist.clone(), rho=state.rho.clone(),
                           gamma=state.gamma.clone(), count=state.count.clone())
        update, new = self.real(state, g, lr, method=method, group=group)
        if follow:
            self.x = self.x + update
        if keep:
            rec["update"] = update
            self.records[k] = rec
        return update, new


def as_step(rec: dict) -> dict:
    """A kept closure as the reference reads it: x, the gradient, the update,
    and the pairs (oldest first, as the state holds them once this
    closure's pair is taken in or refused), their 1/(y.s) and the scale."""
    g, lr = rec["g"], rec["lr"]
    if rec["iteration"] == 0:
        return {"x": rec["x"], "g": g, "update": rec["update"], "pairs": [], "rhos": [], "gamma": 1.0, "lr": lr,
                "first": True}
    S, Y, rho = rec["s_hist"].clone(), rec["y_hist"].clone(), rec["rho"].clone()
    gamma, count = float(rec["gamma"]), int(rec["count"])
    y = g - rec["prev_g"]
    s = rec["prev_step"]
    ys = float((y.float() * s.float()).sum())
    m = S.shape[0]
    if ys > 1e-10:
        w = count % m
        S[w], Y[w] = s.to(S.dtype), y.to(Y.dtype)
        rho[w] = 1.0 / ys
        gamma = ys / float((y.float() * y.float()).sum())
        count += 1
    order = [(count + i) % m for i in range(m)]
    pairs = [(S[j].float(), Y[j].float()) for j in order if rho[j] > 0]
    rhos = [float(rho[j]) for j in order if rho[j] > 0]
    return {"x": rec["x"], "g": g, "update": rec["update"], "pairs": pairs, "rhos": rhos, "gamma": gamma, "lr": lr,
            "first": False}
