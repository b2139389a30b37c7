"""The port's twins of the four examples (``examples/torch_*.py``) end
to end on the CPU at tiny sizes: each ``main([... "--device", "cpu"])``
ends and returns finite numbers; the quickstart reaches a clustered
federation round after its FedAvg warm-ups, the serving twin decodes
the tokens it was asked for, and the split-LM twin federates once."""
import importlib.util
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def finite(*xs) -> bool:
    return all(math.isfinite(float(x)) for x in xs)


def test_quickstart_twin_reaches_a_clustered_round():
    out = load("torch_quickstart").main(
        ["--clients", "4", "--base-size", "24", "--epochs", "4",
         "--n-gen", "60", "--device", "cpu"])
    assert out["rounds"] == ["fedavg", "fedavg", "clustered"]
    assert len(out["losses"]) == 4 and all(
        finite(*m.values()) for m in out["losses"])
    assert finite(out["ga_latency"], out["silhouette"], out["accuracy"],
                  out["f1"], out["fpr"], out["score"])
    assert 1 <= out["k"] <= 4 and 0.0 <= out["accuracy"] <= 1.0


def test_multi_domain_comparison_twin_scores_three_algorithms():
    out = load("torch_multi_domain_comparison").main(
        ["--clients", "4", "--base-size", "24", "--epochs", "1",
         "--n-gen", "60", "--device", "cpu"])
    assert sorted(out) == ["FedGAN", "HuSCF-GAN", "MD-GAN"]
    for row in out.values():
        assert finite(row["latency_model_s"])
        assert sorted(row["metrics"]) == ["blobs", "gratings"]
        for m in row["metrics"].values():
            assert finite(*m.values())


def test_serve_lm_twin_decodes():
    out = load("torch_serve_lm").main(
        ["--batch", "2", "--prompt-len", "16", "--gen", "5",
         "--device", "cpu"])
    assert out["tokens"].shape == (2, 5)
    assert out["cache_tensors"] > 0
    assert np.isfinite(out["last_logits"]).all()
    assert finite(out["prefill_s"], out["decode_s"])


def test_split_lm_training_twin_trains_and_federates():
    out = load("torch_split_lm_training").main(["--iters", "9",
                                                "--device", "cpu"])
    assert out["federated_at"] == 7 and len(out["losses"]) == 9
    assert finite(*out["losses"])
    assert [g[0] for g in out["groups"]] == ["weak", "strong"]


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_multi_domain_comparison",
                                  "torch_serve_lm",
                                  "torch_split_lm_training"])
def test_examples_default_to_the_card(name):
    """Without ``--device`` an example asks for CUDA, which raises where
    there is none: no silent fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load(name).main(["--epochs", "1"] if "comparison" in name or
                        "quickstart" in name else [])
