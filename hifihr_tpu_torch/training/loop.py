"""Epoch-level training and evaluation loop (counterpart of
hifihr_tpu/training/loop.py, the reference's train()/train_an_epoch(),
train_hrnet.py:31-497).

A per-epoch loop over a (possibly concatenated) loader, one cached train and
eval step per dataset name, stepped λ schedules, periodic eval with
Procrustes PA-MPJPE/PA-MPVPE against the ground truth, texture metrics,
checkpoints, and a JSONL metrics log (TensorBoard too when `is_write_tb`
and torch.utils.tensorboard imports).

The host waits for the card only where it needs a value: once before an
epoch (the step count), at every `print_freq`-th step (one readback of the
loss terms), and once after it (the last total and the step count); a
skipped step is decided on the device (steps.make_train_step) and counted
from the step count. Eval keeps its results on the device and reads them
back once, at its end; with `test_refinement` (MANO only, as in the JAX
package) each eval batch's MANO parameters are refined by the test-time fit
(training/fitting.py) and its PA-MPJPE reported as pa_mpjpe_refined_cm.

Over several ranks (parallel/mesh.py; `python -m hifihr_tpu_torch.train`
under torchrun makes the process group) the Trainer trains on the global
batch `config.train_batch`: every rank iterates the same seeded loader and
stages only its rows to its device, and the train step reduces the loss
terms, the skip guard and the gradient over the ranks. Eval splits by
batch, not by row: rank r evaluates (and fits) the whole eval batches i
with i % world == r, at the shapes a one-rank eval runs them at, since
cuDNN and cuBLAS round a row differently in calls of different batch
sizes; the results are summed over the ranks from one zero-filled buffer
of every batch, so every rank computes the metrics of a one-rank eval of
the same weights: to the bit on the CPU; on the card up to the last bits
that the renderer's atomic index_add_ varies between any two runs. Rank 0
alone writes train_log.jsonl, TensorBoard, the demo dumps,
the 2D-error reports and the submissions.
"""

from __future__ import annotations

import json
import logging
import math
import os
import queue
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.data.pipeline import claim, prefetch_to_device, stage
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate
from hifihr_tpu_torch.training import metrics as M
from hifihr_tpu_torch.training.checkpoint import CheckpointManager
from hifihr_tpu_torch.training.steps import make_eval_step, make_sched, make_train_step
from hifihr_tpu_torch.training.train_state import create_train_state
from hifihr_tpu_torch.utils.meters import AverageMeter


def _pad_batch(batch: dict, pad_to: int | None) -> tuple[dict, int]:
    """The batch's arrays padded to `pad_to` rows by repeating the last row,
    and the number of real rows: the JAX package pads a ragged last eval
    batch so, and trims the predictions back; its texture metrics average
    over the padded batch, and so do these."""
    arrs = {k: np.asarray(v) for k, v in batch.items() if not isinstance(v, str)}
    n = arrs["imgs"].shape[0] if "imgs" in arrs else next(
        v.shape[0] for v in arrs.values() if v.ndim
    )
    pad = max(pad_to or 0, n) - n
    if pad:
        arrs = {
            k: (np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                if v.ndim and v.shape[0] == n else v)
            for k, v in arrs.items()
        }
    return arrs, n


def _host(tree: dict, n: int | None = None) -> dict:
    """The tensors of a dict as numpy arrays, cut to their first n rows."""
    return {k: v[:n].detach().cpu().numpy() if v.ndim else v.cpu().numpy()
            for k, v in tree.items() if isinstance(v, torch.Tensor)}


class Trainer:
    def __init__(self, config: Config, model, train_loader, val_loader=None,
                 eval_gt: dict | None = None, out_dir: str | None = None, mesh: Mesh | None = None):
        """`model` is on its device (models/hifihr.py::build_model), which
        the Trainer runs on; `eval_gt` is {'xyz': (N, 21, 3), 'verts':
        (N, 778, 3)} in the val loader's order. `mesh` defaults to that of
        the current process group with `config.fsdp` (one rank without
        one)."""
        self.config = config
        self.model = model
        self.device = next(model.parameters()).device
        self.mesh = mesh if mesh is not None else make_mesh(config.fsdp, self.device)
        if config.train_batch % self.mesh.world:
            raise ValueError(f"train_batch={config.train_batch} does not split over {self.mesh.world} ranks")
        self.lead = self.mesh.rank == 0  # the rank that writes
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.eval_gt = eval_gt
        self.out_dir = out_dir or config.base_out_path
        os.makedirs(self.out_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(self.out_dir, "model"), config.save_mode)
        self.log_path = os.path.join(self.out_dir, "train_log.jsonl")
        self._tb = None
        self._tb_step = 0
        if config.is_write_tb and self.lead:  # reference write_to_tb (traineval_util:488-502)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(self.out_dir, "tb"))
            except ImportError:
                pass

        # every component that runs random-init or derived because a
        # converted checkpoint is absent: one warning line each at startup
        # and a train_log record
        from hifihr_tpu_torch.utils.weights import degraded_components

        degraded = degraded_components(config)
        if degraded:
            for msg in degraded:
                logging.warning("DEGRADED: %s", msg)
            self._log({"degraded_components": degraded})

        # the JAX package draws this batch to initialise its variables; the
        # draw also moves the loader to its next epoch, whose shuffle the
        # first train epoch then takes, in both packages
        sample = next(iter(train_loader))
        replicate(model, self.mesh)
        self.state = create_train_state(model, config, sample, steps_per_epoch=max(len(train_loader), 1),
                                        mesh=self.mesh)
        self.loss_computer = LossComputer(config, self.mesh)
        self._train_steps: dict = {}
        self._eval_steps: dict = {}
        self._lpips = None
        self._fit = None  # test-time MANO fitting, built at its first use
        self.start_epoch = 0
        if config.pretrain_model:
            self.state, saved_epoch = CheckpointManager(
                config.pretrain_model, config.save_mode
            ).restore(self.state)
            # the stored epoch is the last finished one; resume at the next
            # (reference current_epoch offset, train_hrnet.py:452)
            self.start_epoch = saved_epoch + 1
        # module-targeted warm starts (reference train_utils.py:96-111)
        if config.pretrain_texture_model:
            self.state = CheckpointManager(
                config.pretrain_texture_model, config.save_mode
            ).restore_submodules(self.state, ("hand_encoder/tex", "vert_tex"))
        if config.pretrain_rgb2hm:
            self.state = CheckpointManager(
                config.pretrain_rgb2hm, config.save_mode
            ).restore_submodules(self.state, ("rgb2hm",))

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()

    def _step_for(self, dat_name: str, train: bool):
        cache = self._train_steps if train else self._eval_steps
        if dat_name not in cache:
            if train:
                cache[dat_name] = make_train_step(self.model, self.loss_computer, dat_name, self.config)
            else:
                cache[dat_name] = make_eval_step(self.model, dat_name, self.config)
        return cache[dat_name]

    def _lpips_for(self, re_img: torch.Tensor):
        """The LPIPS metric's network on the device, built at the first eval
        that renders 64 px or more (texture_metrics skips it below)."""
        if self._lpips is None and re_img.shape[1] >= 64:
            from hifihr_tpu_torch.losses.lpips import LPIPS

            self._lpips = LPIPS().to(self.device)
        return self._lpips

    def _log(self, record: dict):
        if not self.lead:
            return
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            flat = record.get("eval", record)
            for k, v in flat.items():
                if isinstance(v, (int, float)) and np.isfinite(v):
                    self._tb.add_scalar(k, v, self._tb_step)
            self._tb_step += 1

    def train_epoch(self, epoch: int) -> dict:
        """One epoch with no host sync per step (the module docstring says
        where the host waits)."""
        sched = make_sched(self.config, epoch, self.device)
        loss_meter = AverageMeter()  # sampled at print_freq sync points
        n_img = 0
        step0 = int(self.state.step)  # one readback before the epoch starts
        t_epoch = time.time()
        last_sync_t, last_sync_i = t_epoch, -1
        loss_dic = None
        i = -1
        shard = self.mesh.shard_batch if self.mesh.distributed else None
        for i, dev_batch in enumerate(prefetch_to_device(self.train_loader, self.device, shard=shard)):
            dat_name = dev_batch.pop("dataset", "FreiHand")
            step = self._step_for(dat_name, train=True)
            self.state, loss_dic = step(self.state, dev_batch, sched)
            n_img += dev_batch["imgs"].shape[0] * self.mesh.world
            # mid-training demo dumps (reference train_hrnet.py:167, every
            # demo_freq batches; one eval forward of rank 0's rows and a
            # readback each)
            if self.config.demo_freq and i % self.config.demo_freq == 0 and i > 0 and self.lead:
                out = self._step_for(dat_name, train=False)(dev_batch)
                self._demo_dump(os.path.join(self.out_dir, "pic", f"train_e{epoch}_i{i}.png"),
                                _host(dev_batch), _host(out), epoch)
            if i % self.config.print_freq == 0:
                # one readback of every term; it waits for the whole chain
                values = dict(zip(loss_dic, torch.stack([v.float() for v in loss_dic.values()]).tolist()))
                total = values["total"]
                now = time.time()
                batch_time = (now - last_sync_t) / (i - last_sync_i)
                last_sync_t, last_sync_i = now, i
                if np.isfinite(total):
                    loss_meter.update(total)
                    self._log({"epoch": epoch, "step": i, "loss": total,
                               "batch_time": batch_time, **values})
                else:
                    self._log({"epoch": epoch, "step": i, "skipped_nan_loss": True})
        if loss_dic is not None:
            final = float(loss_dic["total"])  # drain the device chain
            if np.isfinite(final):
                loss_meter.update(final)
        wall = time.time() - t_epoch
        skipped = (i + 1) - (int(self.state.step) - step0)
        ips = n_img / max(wall, 1e-9)
        rec = {"epoch": epoch, "train_loss": loss_meter.avg,
               "images_per_sec": ips, "skipped_steps": skipped}
        self._log(rec)
        return rec

    def _combine(self, results: list, n_valids: list) -> list:
        """Every eval batch's results on every rank, from this rank's
        results of the batches it evaluated (None for the others): all
        batches' tensors laid out in one zero-filled fp32 buffer, each
        filled by its batch's rank, and summed over the ranks in one
        all-reduce, which adds only zeros to every value. Rank 0 evaluated
        batch 0 and broadcasts the layout: each key's shape (past the rows
        for per-row results, whole for the per-batch tex_ scalars) and
        dtype."""
        if not self.mesh.distributed or not results:
            return results
        layout = [None]
        if self.lead:
            layout[0] = [(k, k.startswith("tex_"), tuple(v.shape[0 if k.startswith("tex_") else 1:]), v.dtype)
                         for k, v in results[0].items()]
        dist.broadcast_object_list(layout, src=0, group=self.mesh.group)
        shapes = [[shape if per_batch else (n, *shape) for _, per_batch, shape, _ in layout[0]] for n in n_valids]
        buf = torch.zeros(sum(math.prod(s) for row in shapes for s in row), device=self.device)
        parts = iter(buf.split([math.prod(s) for row in shapes for s in row]))
        views = [{k: next(parts).view(s) for (k, *_), s in zip(layout[0], row)} for row in shapes]
        for res, view in zip(results, views):
            if res is not None:
                for k, v in view.items():
                    v.copy_(res[k])
        dist.all_reduce(buf, group=self.mesh.group)
        return [{k: v.to(dtype) for (k, _, _, dtype), v in zip(layout[0], view.values())} for view in views]

    def _refine(self, out: dict, batch: dict) -> tuple:
        """Test-time MANO fitting (training/fitting.py, the reference's
        mano_fitting): the predicted MANO parameters refined against the
        heatmap branch's 2D keypoints (hm_j2d), else the batch's j2d_gt,
        else the projected joints, with unit confidence. Returns (joints,
        verts), root-relative at joint 9, on the device."""
        from hifihr_tpu_torch.hand.mano import ManoLayer, regress_joints_frei
        from hifihr_tpu_torch.training.fitting import make_fitting_fn

        if self._fit is None:
            mano = ManoLayer(ncomps=self.config.ncomps[1] - 3).to(self.device)
            self._fit = mano, make_fitting_fn(mano, device=self.device)
        mano, fit = self._fit
        target = out.get("hm_j2d", batch.get("j2d_gt", out.get("j2d")))
        conf = torch.ones((*target.shape[:2], 1), dtype=target.dtype, device=target.device)
        p = fit(out["pose_params"], out["shape_params"], out["trans"], out["scale"],
                batch["Ks"][:, :3, :3], target, conf, batch["root_xyz"])
        verts = mano(p["pose"], p["betas"]).verts
        joints = regress_joints_frei(verts, mano.J_regressor)
        root = joints[:, 9:10]
        return joints - root, verts - root

    @torch.no_grad()
    def evaluate(self, epoch: int = -1) -> dict:
        """FreiHAND-style eval: PA-MPJPE / PA-MPVPE in cm
        (train_hrnet.py:216-250), PCK AUC and EPE, per-batch texture metrics
        when rendering (:148-161), the HO3D pred.json submission dump
        (:284-293), and the 2D-error artifacts gated by config.save_2d
        (traineval_util.py:371-442).

        Host batches are padded to val_batch and staged to the device on a
        thread, up to 3 ahead, while the card runs the previous batch; the
        results stay on the device until one readback at the end. Over
        several ranks, rank r evaluates (and fits) the whole batches i with
        i % world == r, so each batch runs at the shapes of a one-rank eval,
        and _combine gives every rank every batch's results."""
        if self.val_loader is None:
            return {}
        refine = self.config.test_refinement and self.config.hand_model == "mano"
        world, rank = self.mesh.world, self.mesh.rank
        results: list = []  # per batch: its results, or None for another rank's batch
        n_valids: list = []
        dat_name = "FreiHand"

        q: queue.Queue = queue.Queue(maxsize=3)
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def produce():
            try:
                for i, batch in enumerate(self.val_loader):
                    arrs, n = _pad_batch(batch, self.config.val_batch)
                    staged = stage(arrs, self.device, stream) if i % world == rank else None
                    q.put((batch.get("dataset", "FreiHand"), n, staged))
                q.put(None)
            except Exception as exc:  # noqa: BLE001 - handed to the consumer, which raises it
                q.put(exc)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        i = -1
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            i += 1
            dat_name, n_valid, staged = item
            n_valids.append(n_valid)
            if staged is None:
                results.append(None)
                continue
            dev_batch = claim(staged)
            out = self._step_for(dat_name, train=False)(dev_batch)
            if i == 0 and self.lead:  # demo dump (reference displadic every demo_freq)
                self._demo_dump(os.path.join(self.out_dir, "pic", f"eval_{epoch}.png"),
                                _host(dev_batch, n_valid), _host(out, n_valid), epoch)
            res = {"joints": out["joints"][:n_valid], "verts": out["mano_verts"][:n_valid]}
            if refine:
                res["refined"] = self._refine(out, dev_batch)[0][:n_valid]
            # 2D per-joint Euclidean errors (reference save_2d,
            # traineval_util.py:428-442): proj = reprojected model joints,
            # pred = heatmap-branch joints, detect = openpose labels
            if self.config.save_2d and "j2d_gt" in dev_batch:
                gt = dev_batch["j2d_gt"]
                for key, j2d in (("proj", out.get("j2d")), ("pred", out.get("hm_j2d")),
                                 ("detect", dev_batch.get("open_2dj"))):
                    if j2d is not None:
                        res[f"err_{key}"] = torch.linalg.norm(gt - j2d, dim=-1)[:n_valid]
            if "re_img" in out and "segms_gt" in dev_batch:
                res.update({f"tex_{k}": v for k, v in M.texture_metrics(
                    out["re_img"], out["re_sil"], dev_batch["imgs"], gt_mask=dev_batch["segms_gt"],
                    lpips=self._lpips_for(out["re_img"]),
                ).items()})  # device scalars; read back once at the end
            results.append(res)
        producer.join()
        results = self._combine(results, n_valids)
        xyz_dev = torch.cat([r["joints"] for r in results])
        verts_dev = torch.cat([r["verts"] for r in results])
        xyz_np, verts_np = xyz_dev.cpu().numpy(), verts_dev.cpu().numpy()
        result = {"epoch": epoch,
                  "split": "val" if self.config.is_val else "evaluation"}
        err_2d = {k: [r[f"err_{k}"] for r in results if f"err_{k}" in r] for k in ("proj", "pred", "detect")}
        if self.config.save_2d and any(err_2d.values()) and self.lead:
            from hifihr_tpu_torch.utils.visualize import save_2d_error_report

            named = {k: torch.cat(v).cpu().numpy() for k, v in err_2d.items() if v}
            result["j2d_errors_px"] = save_2d_error_report(
                os.path.join(self.out_dir, "joint2d_result", str(epoch)), named
            )
        if self.eval_gt is not None:
            n = min(len(xyz_np), len(self.eval_gt["xyz"]))
            gt_xyz = torch.as_tensor(np.asarray(self.eval_gt["xyz"][:n]), device=self.device)
            gt_verts = torch.as_tensor(np.asarray(self.eval_gt["verts"][:n]), device=self.device)
            result["pa_mpjpe_cm"] = float(M.pa_mpjpe(xyz_dev[:n], gt_xyz)) * 100
            result["pa_mpvpe_cm"] = float(M.pa_mpjpe(verts_dev[:n], gt_verts)) * 100
            # PCK curve / AUC / EPE over Procrustes-aligned joints
            # (utils/fh_utils.py EvalUtil :719-815, unwired in the reference)
            aligned = M.align_w_scale(gt_xyz, xyz_dev[:n]).cpu().numpy()
            ev = M.EvalUtil()
            ev.feed(gt_xyz.cpu().numpy(), aligned)
            epe_mean, epe_med, auc, _, _ = ev.get_measures()
            result["pa_epe_mean_cm"] = epe_mean * 100
            result["pa_epe_median_cm"] = epe_med * 100
            result["pck_auc"] = auc
            if refine:
                refined = torch.cat([r["refined"] for r in results])[:n]
                result["pa_mpjpe_refined_cm"] = float(M.pa_mpjpe(refined, gt_xyz)) * 100
        for k in [k for k in results[0] if k.startswith("tex_")]:
            per_batch = torch.stack([r[k] for r in results]).tolist()
            result[k] = float(np.mean(per_batch))
        # HO3D always dumps the submission file; config.save_3d extends the
        # dump to every dataset (reference train_hrnet.py:119,200,280-283)
        if (dat_name == "HO3D" or self.config.save_3d) and self.lead:
            from hifihr_tpu_torch.training.submission import dump_predictions

            result["pred_json"] = dump_predictions(
                os.path.join(self.out_dir, "json", f"pred_{epoch}.json"
                             if self.config.save_3d else "pred.json"),
                xyz_np, verts_np, dat_name=dat_name,
            )
        self._log({"epoch": epoch, "eval": result})
        return result

    def _demo_dump(self, path: str, examples: dict, outputs: dict, epoch: int):
        """Demo grid and optional per-image dumps (reference displadic,
        visualize_util.py:640-691; img_wise_save writes individual panels).
        A failure is logged as viz_error and never stops training or eval."""
        try:
            from hifihr_tpu_torch.utils.visualize import save_prediction_grid, write_png

            examples = {
                k: (v.astype(np.float32) / (255.0 if k == "imgs" else 1.0)
                    if v.dtype == np.uint8 else v)
                for k, v in examples.items()
            }
            save_prediction_grid(path, examples, outputs)
            if self.config.img_wise_save and "re_img" in outputs:
                d = os.path.join(os.path.dirname(path), f"img_wise_{epoch}")
                os.makedirs(d, exist_ok=True)
                re_img = outputs["re_img"]
                raw = examples.get("imgs", re_img)
                for bi in range(min(len(re_img), 8)):
                    write_png(os.path.join(d, f"{bi:03d}_re_img.png"),
                              (np.clip(re_img[bi], 0, 1) * 255).astype(np.uint8))
                    write_png(os.path.join(d, f"{bi:03d}_raw.png"),
                              (np.clip(raw[bi, ..., :3], 0, 1) * 255).astype(np.uint8))
        except Exception as exc:  # noqa: BLE001 - viz must never kill eval/train
            self._log({"viz_error": str(exc)})

    def fit(self):
        cfg = self.config
        best = np.inf
        for epoch in range(self.start_epoch, cfg.total_epochs):
            self.train_epoch(epoch)
            if (epoch + 1) % cfg.save_interval == 0:
                self.ckpt.save(self.state, epoch)
                # if_test gates the eval epoch at each save point
                # (reference train_hrnet.py:475-484)
                if not cfg.if_test:
                    continue
                ev = self.evaluate(epoch)
                score = ev.get("pa_mpjpe_cm", np.inf)
                if score < best:
                    best = score
                    self._log({"best_epoch": epoch, "pa_mpjpe_cm": score})
        return best
