"""`chip_smoke.py`'s one-step card-vs-CPU train check (phase 18) holds each
gradient leaf.

Run on the CPU against the CPU on reduced opt-350m, with the first ("card")
side's gradients changed in one leaf: zeroed, sign-flipped or permuted.
Each such step must fail the check, although the grad-norm rule alone
passes all three (a zeroed final-norm gradient moves the global norm by
less than its 1e-3; a flip or a permutation not at all). The unchanged
step passes. The same in bf16 (params, compute and moments), where the
check holds each leaf by its distance to the float32 gradient.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

import repro_torch.training.train as train_mod
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training.optimizer import AdamWConfig

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zero_final_norm(grads):
    grads["final_norm"] = {k: torch.zeros_like(v)
                           for k, v in grads["final_norm"].items()}


def _flip_first_norm(grads):
    norm = grads["stack"][0]["sub_0"]["norm1"]
    norm["scale"] = -norm["scale"]


def _permute_embedding(grads):
    e = grads["embed"]["embedding"]
    perm = torch.randperm(e.shape[0], generator=torch.Generator().manual_seed(1))
    grads["embed"]["embedding"] = e[perm]


@pytest.mark.parametrize("change", [None, _zero_final_norm, _flip_first_norm,
                                    _permute_embedding],
                         ids=["unchanged", "zeroed", "sign-flipped",
                              "permuted"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_step_check_holds_each_gradient_leaf(change, dtype, monkeypatch):
    smoke = _chip_smoke()
    cfg = get_config("opt-350m", reduced=True, param_dtype=dtype,
                     compute_dtype=dtype)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    real = train_mod.grads_of

    def grads_of(m, p, batch):
        loss, aux, grads = real(m, p, batch)
        if m is model and change is not None:
            change(grads)
        return loss, aux, grads
    monkeypatch.setattr(train_mod, "grads_of", grads_of)
    opt_cfg = AdamWConfig(lr_peak=smoke.TRAIN_LR, warmup_steps=2,
                          total_steps=smoke.TRAIN_STEPS, moment_dtype=dtype)
    bf16 = dtype == "bfloat16"
    if change is None:
        row = smoke.one_step_check(torch.device("cpu"), model, params,
                                   opt_cfg, seed=0)
        if bf16:
            assert row["f32_rule_excess"] <= 0
        else:
            assert row["grad_max_leaf_l2_rel"] <= smoke.TRAIN_GRAD_L2_TOL
        assert row["params_vs_cpu_adamw_on_card_grads"] <= smoke.TRAIN_PARAM_TOL
        return
    with pytest.raises(AssertionError) as err:
        smoke.one_step_check(torch.device("cpu"), model, params, opt_cfg,
                             seed=0)
    row = err.value.args[0]
    if bf16:
        assert row["f32_rule_excess"] > 0
    else:
        assert row["grad_max_leaf_l2_rel"] > smoke.TRAIN_GRAD_L2_TOL
    assert abs(row["grad_norm_card"] / row["grad_norm_cpu"] - 1) < 1e-3
