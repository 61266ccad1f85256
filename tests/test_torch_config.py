"""The port's Configer against the JAX package's, exact equality (they are
the same Python on the same files): on every config under configs/ and on
a python-dict config, with the same dotted overrides, `to_dict()`, `dump`,
`clone`, `get`/`get_strict`/`exists`, the `conditions` predicates and the
dataset helpers agree, and they still agree after the same `update`, `add`,
`set` and `plus_one` calls."""

import glob
import json
import os

import pytest

from mds_tpu.config import Configer as JConfiger
from mds_tpu_torch.config import Configer, _literal, set_cfg_from_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))
OVERRIDES = ["lr.max_iter", "7", "train.cropsize=[64, 32]", "--seed", "3",
             "model_kwargs.aux", "False", "dataset1.reader_kwargs",
             "{'n_cats': 19, 'size': [1024, 2048], 'length': 64}",
             "train.note", "plain text", "loss.ohem_thresh=0.5"]
PY_CONFIG = ("cfg = dict(model_name='bisenetv2', n_datasets=1,\n"
             "           dataset1=dict(n_cats=19, data_reader='Synthetic'),\n"
             "           lr=dict(lr_start=5e-3, max_iter=10), loss=dict(type='OhemCELoss'))\n")

_PREDICATES = ("use_multi_dataset", "pred_sw_offset", "pred_dt_offset", "use_sw_offset",
               "use_dt_offset", "use_ground_truth", "pred_ml_dt_offset")


def _same(a, b, tmp_path):
    assert a.to_dict() == b.to_dict()
    a.dump(str(tmp_path / "a.json"))
    b.dump(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    assert a.clone().to_dict() == b.to_dict()
    assert a.n_datasets == b.n_datasets
    for i in range(a.n_datasets):
        assert a.dataset_cfg(i) == b.dataset_cfg(i) and a.n_cats(i) == b.n_cats(i)
    ca, cb = a.conditions, b.conditions
    for name in _PREDICATES:
        assert getattr(ca, name) == getattr(cb, name), name
    for probe in ("Ohem", "NLL", "bisenetv2", "snp"):
        assert ca.loss_contains(probe) == cb.loss_contains(probe)
        assert ca.model_contains(probe) == cb.model_contains(probe)
    assert ca.config_equals(("lr", "max_iter"), 7) == cb.config_equals(("lr", "max_iter"), 7)
    assert ca.config_exists(("train", "note")) == cb.config_exists(("train", "note"))
    for keys in (("lr", "max_iter"), ("train", "cropsize"), ("no", "such"), ("seed",)):
        assert a.get(*keys) == b.get(*keys) and a.exists(*keys) == b.exists(*keys)


def _mutate(c):
    c.update(["lr", "warmup_iters"], 3)
    c.update("fresh", {"x": 1})
    c.set(["train", "ckpt_interval"], 5)
    c.add(["train", "added"], [1, 2])
    with pytest.raises(KeyError):
        c.add(["train", "added"], 0)
    return [c.plus_one("train", "iters"), c.plus_one("train", "iters")]


@pytest.mark.parametrize("path", CONFIGS + ["python"],
                         ids=[os.path.basename(p) for p in CONFIGS] + ["python"])
def test_configer_matches_jax(path, tmp_path):
    if path == "python":
        path = str(tmp_path / "cfg.py")
        with open(path, "w") as f:
            f.write(PY_CONFIG)
    a = Configer(config_file=path, args_parser=OVERRIDES)
    b = JConfiger(config_file=path, args_parser=OVERRIDES)
    _same(a, b, tmp_path)
    assert a.get("lr", "max_iter") == 7 and a.get("train", "cropsize") == [64, 32]
    assert a.get("train", "note") == "plain text" and a.get("seed") == 3
    assert _mutate(a) == _mutate(b) == [1, 2]
    _same(a, b, tmp_path)
    for c in (a, b):
        with pytest.raises(KeyError):
            c.get_strict("no", "such")
        with pytest.raises(ValueError):
            c.apply_overrides(["lr.max_iter"])


def test_configer_loading_rules(tmp_path):
    """Literal parsing, the python-config rule, and the file types."""
    assert _literal("[1, 2]") == [1, 2] and _literal("1e-3") == 1e-3
    assert _literal("True") is True and _literal("not a literal") == "not a literal"
    bad = tmp_path / "bad.py"
    bad.write_text("x = 1\n")
    with pytest.raises(ValueError, match="cfg"):
        Configer(config_file=str(bad))
    with pytest.raises(ValueError, match="unsupported"):
        Configer(config_file=str(tmp_path / "c.yaml"))
    c = set_cfg_from_file(CONFIGS[0])
    with open(CONFIGS[0]) as f:
        assert c.to_dict() == json.load(f)
    assert Configer(configs={"a": {"b": 1}}, args_parser=["a.b", "2"]).get("a", "b") == 2
