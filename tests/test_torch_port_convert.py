"""The port's checkpoint converter
(``python -m gaussianformer_tpu_torch.convert_checkpoint``) against the JAX
package's: a reference-named ``state_dict`` of a tiny prob and a tiny v1
config, with seeded numpy values and the reference's entries that carry
no weight (``num_batches_tracked``, the spconv's ``pc_range`` /
``grid_size``, the head's ``empty_*`` buffers), goes through
``gaussianformer_tpu/utils/torch_convert.py::convert_full_state_dict`` and
then the port's ``utils/convert.py::jax_to_state_dict``, and through the
port's converter: equal leaf for leaf, exactly. ``--strict`` exits nonzero
on a stray key, a wrong shape raises, and the eval CLI picks up the
written directory."""
import os

import numpy as np
import pytest
import torch

from gaussianformer_tpu.utils.torch_convert import convert_full_state_dict

from gaussianformer_tpu_torch import convert_checkpoint
from gaussianformer_tpu_torch import eval as eval_cli
from gaussianformer_tpu_torch.configs import get_config
from gaussianformer_tpu_torch.models.segmentor import build_segmentor
from gaussianformer_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                       load_checkpoint)
from gaussianformer_tpu_torch.utils.convert import jax_to_state_dict

CONFIGS = ("prob_gs6400_tiny", "gs25600_solid_tiny")


def reference_state_dict(cfg, seed=0):
    """A reference checkpoint's ``state_dict`` for ``cfg``: every tensor
    of the model under its reference name with seeded values (positive
    variances), and the entries the reference saves beside them."""
    template = build_segmentor(cfg, device="cpu", seed=None).state_dict()
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in template.items():
        a = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if k.endswith("running_var"):
            a = np.abs(a) + 0.5
        sd[k] = torch.from_numpy(a)
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    for i, op in enumerate(cfg.operation_order):
        if op == "spconv":
            sd[f"encoder.layers.{i}.pc_range"] = torch.tensor(cfg.pc_range)
            sd[f"encoder.layers.{i}.grid_size"] = torch.tensor(
                cfg.spconv_grid_size)
    if cfg.with_empty:
        for buf, n in (("mean", 3), ("scale", 3), ("rot", 4),
                       ("sem", cfg.num_classes), ("opa", 1)):
            sd[f"head.empty_{buf}"] = torch.ones(n)
    return sd


@pytest.mark.parametrize("name", CONFIGS)
def test_converter_matches_the_jax_path(name):
    """Leaf for leaf, exactly, the JAX converter then ``jax_to_state_dict``
    and the port's converter; both drop the same entries and map the
    rest."""
    cfg = get_config(name)
    sd = reference_state_dict(cfg)
    params, stats, unmapped = convert_full_state_dict(
        {k: v.numpy() for k, v in sd.items()}, cfg.operation_order,
        lifter="v1" if cfg.version == 1 else "v2")
    assert unmapped == []
    via_jax = jax_to_state_dict({"params": params, "batch_stats": stats})
    template = build_segmentor(cfg, device="cpu", seed=None).state_dict()
    got, unmapped, missing = convert_checkpoint.convert_state_dict(
        sd, template)
    assert unmapped == [] and missing == []
    assert sorted(got) == sorted(via_jax) == sorted(template)
    for k, ref in via_jax.items():
        assert got[k].dtype == ref.dtype, k
        assert torch.equal(got[k], ref), k
    dropped = set(sd) - set(got)
    assert dropped and all(convert_checkpoint.DROPPED.fullmatch(k)
                           for k in dropped)


def test_converter_strict_and_shapes(tmp_path):
    """``--strict`` exits nonzero on a stray reference key (and writes
    nothing); without it the stray key is reported and the checkpoint
    written; a tensor of another shape raises."""
    cfg = get_config("prob_gs6400_tiny")
    sd = reference_state_dict(cfg)
    path = tmp_path / "stray.pth"
    torch.save({"state_dict": {**sd, "head.stray_weight": torch.ones(3)}},
               path)
    out = tmp_path / "strict"
    args = ["--config", cfg.name, "--torch-ckpt", str(path), "--device",
            "cpu"]
    assert convert_checkpoint.main(args + ["--out", str(out),
                                           "--strict"]) == 1
    assert latest_checkpoint(str(out)) is None
    assert convert_checkpoint.main(args + ["--out", str(out)]) == 0
    assert latest_checkpoint(str(out)) is not None
    key = next(k for k in sd if k.endswith("conv1.weight"))
    bad = {**sd, key: torch.zeros(sd[key].shape[0] + 1, *sd[key].shape[1:])}
    template = build_segmentor(cfg, device="cpu", seed=None).state_dict()
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        convert_checkpoint.convert_state_dict(bad, template)


def test_eval_picks_up_the_converted_checkpoint(tmp_path, capsys):
    """The converter's directory (``ckpt_000000000.pt`` + ``latest``) is
    what the eval CLI evaluates: its model holds the reference's tensors
    and it prints its mIoU."""
    cfg = get_config("prob_gs6400_tiny")
    sd = reference_state_dict(cfg, seed=1)
    path = tmp_path / "ref.pth"
    torch.save(sd, path)
    out = str(tmp_path / "converted")
    assert convert_checkpoint.main([
        "--config", cfg.name, "--torch-ckpt", str(path), "--out", out,
        "--strict", "--device", "cpu"]) == 0
    ckpt = latest_checkpoint(out)
    assert os.path.basename(ckpt) == "ckpt_000000000.pt"
    assert set(load_checkpoint(ckpt)) >= {"model", "epoch", "global_iter"}
    trainer = eval_cli.main(["--config", cfg.name, "--work-dir", out,
                             "--synthetic", "--num-workers", "0",
                             "--device", "cpu"])
    held = trainer.model.state_dict()
    for k, v in held.items():
        assert torch.equal(v, sd[k]), k
    assert "mIoU:" in capsys.readouterr().out
