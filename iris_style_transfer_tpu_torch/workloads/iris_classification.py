"""Train the iris classifiers on VGG19 features (OpenEDS2019), data-parallel.

Counterpart of ``iris_style_transfer_tpu/workloads/iris_classification.py``
(reference ``iris_classification.py``): Classifier1 on the final VGG19
features and Classifier2 on the style statistics, trained together with
Adam on ``CE(p1, y) + CE(p2, y)``, over a frozen VGG19 by default
(``--no-freeze_vgg`` trains it too).  Per epoch the train and test metrics
are logged under ``train/c1/ ... test/c2/`` and ``train/steps_per_sec``;
every ``save_period`` epochs without augmentation the heads are saved in
the JAX package's checkpoint format (``step_%08d.npz``, readable by the
IST mains' ``-path1/-path2``) beside the full training state for
``--resume``.  Flags are the JAX workload's, plus ``--device``.

On a mesh (``--n_devices N``, or ``torchrun``; ``parallel/mesh.py``) every
rank walks the same global batches and trains on its block of each: the
gradients are averaged over the data group in one packed ``all_reduce``
before Adam, the dropout masks are drawn for the whole batch and cut, and
the logits are gathered, so a run on N ranks computes what one device
does.  ``--model_parallel 2`` splits the heads' fc0/fc1 over the model
group (``mlp_tp_spec``).  Rank 0 alone logs and writes checkpoints, which
always hold the whole heads.

The crops are built once per split on the device (``build_ir_dataset``)
and staged back per batch from pinned host memory on a side stream.  With
a frozen VGG19 its forward runs under ``torch.no_grad()``.  Logits stay on
the device and are fetched once per epoch.  With ``--data_dir/openeds2019``
present the run reads that OpenEDS2019 tree (frames only,
``data/openeds2019.py:load_data_openeds2019``); without it, the synthetic
twin.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..data import batch_iterator, build_ir_dataset, load_data_openeds2019, prefetch_to_device, synthetic_openeds2019
from ..models import Classifier1, Classifier2, RITnet, VGG19, load_pretrained
from ..ops.image import gray_to_rgb, to_unit_float
from ..ops.metrics import classification_metrics, cross_entropy
from ..parallel.mesh import Mesh, gather_batch, mlp_tp_spec, one_rank, pmean_grads, replicated, shard_params
from ..runtime import MetricLogger, StepTimer, resume_training_state, save_training_state, sync, trainable
from ..runtime.config import (
    WorkloadConfig,
    add_common_args,
    main_mesh,
    parse_config,
    resolve_device,
    run_on_ranks,
    spawns_ranks,
)
from ..utils import seed as seed_all

CKPT_DIR = "saved/checkpoints/iris_classification"


def make_steps(compute_dtype, mesh: Mesh | None = None):
    """``train_step(train_params, opt, vgg_frozen, x, y, gen)`` and
    ``eval_step(train_params, vgg_frozen, x)`` on (B, H, W, 1) u16 crops.
    ``train_params`` holds ``c1``, ``c2`` and, when VGG19 trains, ``vgg``;
    dropout is on where ``gen`` is given.  With ``mesh``, ``x`` and ``y``
    are this rank's block of the batch."""

    def forward(train_params, vgg_frozen, x, gen):
        vgg = train_params.get("vgg", vgg_frozen)
        x = gray_to_rgb(to_unit_float(x)).permute(0, 3, 1, 2)  # crops stage as u16
        with torch.set_grad_enabled(torch.is_grad_enabled() and "vgg" in train_params):
            final, _, style = VGG19.apply(vgg, x, compute_dtype=compute_dtype)
        train = gen is not None
        p1 = Classifier1.apply(train_params["c1"], final, train=train, gen=gen, mesh=mesh)
        p2 = Classifier2.apply(train_params["c2"], style, train=train, gen=gen, mesh=mesh)
        return p1, p2

    def train_step(train_params, opt, vgg_frozen, x, y, gen):
        p1, p2 = forward(train_params, vgg_frozen, x, gen)
        loss = cross_entropy(p1, y) + cross_entropy(p2, y)  # reference :73
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            pmean_grads(mesh, opt.param_groups[0]["params"])
        opt.step()
        return loss.detach(), p1.detach(), p2.detach()

    @torch.no_grad()
    def eval_step(train_params, vgg_frozen, x):
        return forward(train_params, vgg_frozen, x, None)

    return train_step, eval_step


def _load_data(cfg: WorkloadConfig):
    base = os.path.join(cfg.data_dir, "openeds2019")
    if os.path.isdir(base):
        return load_data_openeds2019(cfg.test_split_ratio, load_seg=False, data_dir=base)
    print(f"[data] {base} not found -> synthetic dataset")
    return synthetic_openeds2019(n_per_user=8, num_users=8, seed=cfg.seed)


def _metrics(prefix: str, labels: torch.Tensor, preds: dict, num_class: int, log: dict) -> None:
    for name, pred in preds.items():
        m = classification_metrics(labels, pred.float(), num_class)
        log.update({f"{prefix}/{name}/{k}": float(v) for k, v in m.items()})


def seeded_vgg19(seed: int, device, vgg_weights: str = "") -> tuple[dict, torch.Generator]:
    """The VGG19 the classifier heads are trained against: the ported
    weights when given or bundled, else ``VGG19.init`` as the first draw of
    ``seed_all(seed)``'s generator.  Returns the generator too, for the
    draws that follow.  The replication tools build their VGG19 here, so
    their evaluation sees the trainer's features by construction."""
    gen = seed_all(seed, verbose=False)
    return load_pretrained("vgg19", vgg_weights, lambda: VGG19.init(gen, device), device), gen


def iris_classification(cfg: WorkloadConfig, device: torch.device, vgg_weights: str = "", data=None,
                        ritnet_params: dict | None = None, ckpt_dir: str = CKPT_DIR,
                        mesh: Mesh | None = None) -> dict:
    """Train both heads; ``data`` (the 7-tuple of ``load_data_openeds2019``)
    and ``ritnet_params`` replace the loaded dataset and the bundled RITnet,
    and the checkpoints go to ``ckpt_dir``.  ``mesh`` is the run's (None:
    ``device`` alone)."""
    mesh = mesh if mesh is not None else one_rank(device)
    seed_all(cfg.seed)
    train_x, train_y, _, test_x, test_y, _, num_class = _load_data(cfg) if data is None else data
    print("number of classes:", num_class)
    if len(train_y) < cfg.bs:
        raise SystemExit(f"{len(train_y)} training crops give no step at -bs {cfg.bs} "
                         "(the last short batch is dropped); lower -bs")
    if cfg.bs % mesh.shape["data"]:
        raise SystemExit(f"batch size {cfg.bs} not divisible by {mesh.shape['data']} data shards")

    if ritnet_params is None:
        ritnet_params = RITnet.pretrained(device)
    aug_gen = torch.Generator().manual_seed(cfg.seed)  # rotation / perspective draws
    aug = (cfg.rotation_prob, cfg.rotation_degree, cfg.perspect_prob, cfg.perspect_degree, cfg.glint_threshold)
    tr_x, tr_y = build_ir_dataset(train_x, train_y, ritnet_params, aug_gen, *aug, device=device)
    te_x, te_y = build_ir_dataset(test_x, test_y, ritnet_params, aug_gen, *aug, device=device)

    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    vgg_params, gen = seeded_vgg19(cfg.seed, device, vgg_weights)
    train_params = {
        "c1": Classifier1.init(gen, num_class, device),
        "c2": Classifier2.init(gen, num_class=num_class, device=device),
    }
    # the heads split over the model group, or not at all; VGG19 replicated
    spec = {"c1": mlp_tp_spec(), "c2": mlp_tp_spec()} if mesh.shape["model"] > 1 else None
    vgg_frozen = None
    if cfg.freeze_vgg:
        vgg_frozen = replicated(mesh, VGG19.cast(vgg_params, compute_dtype))  # once, ahead of every step
    else:
        train_params["vgg"] = vgg_params
    train_params = shard_params(mesh, train_params, spec)
    opt = torch.optim.Adam(trainable(train_params), lr=cfg.lr)
    train_step, eval_step = make_steps(compute_dtype, mesh)

    start_epoch = resume_training_state(ckpt_dir, train_params, opt, mesh, spec) if cfg.resume else 0
    if start_epoch:
        print(f"resumed from epoch {start_epoch}")

    logger = MetricLogger(cfg.project, cfg.name or f"seed {cfg.seed}", cfg.to_dict(), enabled=mesh.is_main)
    timer = StepTimer()
    drop_gen = torch.Generator(device=device)
    final_metrics: dict = {}
    for e in range(start_epoch, cfg.epochs):
        preds1, preds2, labels = [], [], []
        it = batch_iterator((tr_x, tr_y), cfg.bs, shuffle=True, seed=cfg.seed + e, drop_remainder=True)
        for bi, (x, y) in enumerate(prefetch_to_device(it, device, mesh=mesh)):
            drop_gen.manual_seed(cfg.seed * 1_000_000_000 + e * 10_000 + bi)  # per step, so resume repeats it
            with timer:
                _, p1, p2 = train_step(train_params, opt, vgg_frozen, x, y, drop_gen)
                sync(device)
            preds1.append(gather_batch(mesh, p1))
            preds2.append(gather_batch(mesh, p2))
            labels.append(gather_batch(mesh, y))
        log: dict = {}
        # one read back per epoch: the logits never leave the device per step
        _metrics("train", torch.cat(labels).cpu(), {"c1": torch.cat(preds1).cpu(), "c2": torch.cat(preds2).cpu()},
                 num_class, log)

        preds1, preds2 = [], []
        for batch in prefetch_to_device(batch_iterator((te_x, te_y), cfg.bs), device, mesh=mesh):
            p1, p2 = eval_step(train_params, vgg_frozen, batch[0])
            preds1.append(gather_batch(mesh, p1))
            preds2.append(gather_batch(mesh, p2))
        n = len(te_y)  # the padded rows of the last batch come last
        _metrics("test", torch.as_tensor(te_y), {"c1": torch.cat(preds1)[:n].cpu(), "c2": torch.cat(preds2)[:n].cpu()},
                 num_class, log)
        log["train/steps_per_sec"] = timer.per_sec()
        logger.log(log)
        final_metrics = log

        # the reference's checkpoint conditions (:111-113), plus the full state
        if cfg.save_period > 0 and cfg.rotation_prob == cfg.perspect_prob == 0 and (e + 1) % cfg.save_period == 0:
            save_training_state(ckpt_dir, e + 1, train_params, opt, mesh, spec)

    logger.finish()
    return final_metrics


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser()
    defaults = WorkloadConfig(project="iris-style-transfer", epochs=500, bs=64, lr=1e-5)
    add_common_args(parser, defaults)
    parser.add_argument("--vgg_weights", type=str, default="",
                        help="ported VGG19 IMAGENET1K_V1 npz in the JAX package's format")
    cfg, args = parse_config(parser, defaults, argv)
    device = resolve_device(args.device)
    if spawns_ranks(cfg, device):
        return run_on_ranks(main, argv, cfg, device)
    mesh = main_mesh(cfg, device)
    cfg.name = f"seed {cfg.seed} rd {cfg.rotation_degree} pd {cfg.perspect_degree} lr {cfg.lr}"
    return iris_classification(cfg, mesh.device, vgg_weights=args.vgg_weights, mesh=mesh)


if __name__ == "__main__":
    main()
