"""The evaluation slice: `eval_model` of the port against the JAX
package's, on BiSeNetV2 from configs/test_synthetic.json (two datasets,
64×64 Synthetic frames, 8 a dataset), f32, the same weights in both
packages (the port's seeded init with randomized BN, through
`bisenetv2_from_torch` and back with `bisenetv2_state_dict_from_jax`).

Modes ss, uni and contrast here; msf and mscf in
tests/test_torch_eval_ms.py (tests/torch_eval_parity.py holds the
helpers). The gates: each dataset's mIoU within 2e-3 of JAX's, and each
batch's predictions agreeing on >= 99.9% of pixels (measured: every pixel
in every mode). JAX's predictions come from a host callback on its
`confusion_hist` (inside its jitted batch function) and, for mscf, whose
argmax runs on the host, from its `MscEvalCrop.__call__` with one line
added that records them.

Port-only: the bf16 deploy routes (the plain versions of their kernels on
the CPU) against the bf16 plain path in ss, on the weights of seeds 0-5:
every batch's logits within rel 2e-2 of the plain path's (chip_smoke.py's
LOGITS_GATE; measured 0.0064-0.0125 over the seeds), and the pixel share
that agrees, averaged over the seeds, > 0.995 (bench.py:296-297). A
random-weight bf16 model's argmax flips on near-ties at a rate the seed
sets: the share was 0.9917-0.9995 a seed (mean 0.9965). Also aux,
label_link, unlabel and ssc; the modes a model lacks raise, and dsg runs
(against JAX's: tests/test_torch_data_stage.py).
"""

import numpy as np
import pytest
import torch

import mds_tpu_torch.evaluation.evaluator as tev
from mds_tpu_torch.config import Configer
from mds_tpu_torch.data.loader import get_data_loader
from torch_eval_parity import (  # noqa: F401 — one_torch_thread: autouse
    N_CLASSES,
    WEIGHT_SEED,
    check_against_jax,
    configs,
    deploy_routes,
    make_variables,
    one_torch_thread,
    port_eval,
    port_model,
)
from torch_parity import ARGMAX_GATE, LOGITS_GATE, rel_err

BF16_SEEDS = range(6)


@pytest.fixture(scope="module")
def weights():
    return make_variables(N_CLASSES, 2, WEIGHT_SEED)


@pytest.mark.parametrize("mode", ["ss", "uni", "contrast"])
def test_eval_model_matches_jax(weights, mode):
    check_against_jax(weights, mode)


def test_bf16_deploy_routes_match_the_plain_path(monkeypatch):
    """ss in bf16 on the deploy routes (stem kernel, detail fusion and
    tail, depthwise kernel; their plain versions on the CPU) against the
    bf16 plain path, on the weights of each seed: every route called once
    a forward (16 depthwise convs), each batch's logits within
    LOGITS_GATE, the mean pixel share that agrees > 0.995."""
    from mds_tpu_torch.ops import depthwise, stem

    calls = {"detail_s1s2_fused": 0, "stemblock_fused": 0, "detail_tail_fused": 0,
             "depthwise3x3": 0}
    for mod in (stem, depthwise):
        for name in calls:
            if hasattr(mod, name):
                real = getattr(mod, name)

                def counted(*a, _real=real, _name=name, **k):
                    calls[_name] += 1
                    return _real(*a, **k)

                monkeypatch.setattr(mod, name, counted)
    make_logits_fn, logits = tev.make_logits_fn, []

    def logged(*a, **k):
        fn = make_logits_fn(*a, **k)

        def logits_fn(im, dataset):
            logits.append(fn(im, dataset))
            return logits[-1]

        return logits_fn

    monkeypatch.setattr(tev, "make_logits_fn", logged)
    shares = []
    for seed in BF16_SEEDS:
        model = port_model(make_variables(N_CLASSES, 2, seed), torch.bfloat16)
        plain, pseen = port_eval(model, "ss")
        plain_logits = logits[:]
        logits.clear()
        calls.update({k: 0 for k in calls})
        with deploy_routes():
            routed, rseen = port_eval(model, "ss")
        assert calls == {"detail_s1s2_fused": 16, "stemblock_fused": 16,
                         "detail_tail_fused": 16, "depthwise3x3": 16 * 16}, calls
        assert len(logits) == len(plain_logits) == 16
        rels = [rel_err(r.float(), p.float()) for r, p in zip(logits, plain_logits)]
        logits.clear()
        assert max(rels) <= LOGITS_GATE, (seed, rels)
        assert np.allclose(routed, plain, rtol=0, atol=5e-3), (seed, routed, plain)
        shares.append(float(np.mean([(r == p).mean()
                                     for (r, _), (p, _) in zip(rseen, pseen)])))
    assert np.mean(shares) > ARGMAX_GATE, shares


def test_port_only_modes(weights):
    """aux is ss's protocol, label_link uni's without the extra bin (which
    no pixel reaches, so the mIoU is the same), unlabel contrast's with the
    logits truncated to the n_cats a BiSeNetV2 emits anyway; ssc runs.
    On 2 frames of each dataset."""
    cfg = configs(Configer)
    for i in (1, 2):
        cfg.update([f"dataset{i}", "reader_kwargs", "length"], 2)
    model = port_model(weights)
    got = {m: port_eval(model, m, cfg)[0] for m in
           ("ss", "aux", "uni", "label_link", "contrast", "unlabel", "ssc")}
    assert got["aux"] == got["ss"]
    assert got["label_link"] == got["uni"]
    assert got["unlabel"] == got["contrast"]
    assert all(0.0 <= m <= 1.0 for m in got["ssc"]) and len(got["ssc"]) == 2


@pytest.mark.parametrize("mode,item", [("unseen", "item 6"), ("clip", "item 6"),
                                       ("emb", "item 7"), ("dsg", "item 6")])
def test_waiting_modes_raise(weights, mode, item):
    """The modes a BiSeNetV2 has no method for (unseen, clip: the flagship
    snp_rn18's; emb: the contrast family's) raise; clip also runs, on a
    train.mode clip checkpoint's bundle (the alternating trainer's
    snp_rn18, configs/test_synthetic_gnn.json shrunk); dsg, which waited
    for the loader's stage, runs: the contrast protocol over the stage-2
    lists, which the Synthetic reader does not read."""
    from mds_tpu_torch.evaluation.drivers import build_eval_bundle, run_evaluation

    if mode == "clip":
        small = Configer(config_file="configs/test_synthetic_gnn.json", args_parser=[
            "backbone.layers", "[1, 1, 1, 1]", "backbone.planes", "[64, 16, 24, 32]",
            "backbone.num_features", "16", "train.mode", "clip"])
        mious = run_evaluation(small, mode="clip", work_dir="/nonexistent", device="cpu")
        assert len(mious) == 2 and all(0.0 <= m <= 1.0 for m in mious)
    cfg = configs(Configer)
    if mode == "dsg":
        mious = run_evaluation(cfg, mode=mode, device="cpu", work_dir="/nonexistent")
        assert len(mious) == 2 and all(0.0 <= m <= 1.0 for m in mious)
        assert mious == port_eval(build_eval_bundle(cfg, work_dir="/nonexistent",
                                                    device="cpu"), "contrast", cfg)[0]
        return
    with pytest.raises(NotImplementedError, match=item):
        tev.eval_model(cfg, port_model(weights), get_data_loader(cfg, "eval"), mode=mode)
