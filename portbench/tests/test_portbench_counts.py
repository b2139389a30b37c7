"""The FLOP count behind ``step_mfu`` against
``torch.utils.flop_counter.FlopCounterMode`` over the reference's
training step, at Table 3's widths: one client of 2 images under each
of three cuts (the counter's formula for the backward of a grouped
convolution, which several clients' copies of a layer run as, grows
with the groups, so each cut is counted on a client of its own)."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import registry
from portbench.reference import cgan, counts
from portbench.weights import make_weights


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cut", [((1, 4), (1, 4)), ((2, 3), (2, 4)),
                                 ((0, 5), (1, 3))])
def test_step_flops_match_the_counter(cut):
    model = registry.cell(registry.load(), "gan100-train")["config"]["model"]
    K, b = 1, 2
    cuts = [cut]
    W = make_weights(model, K, 5, "cpu")
    leaves, topo = {}, {}
    for i, net in enumerate(("G", "D")):
        topo[net] = cgan.topology(model, net, [c[i] for c in cuts], "cpu")
        L = {}
        for l, spec in enumerate(cgan.layer_specs(model, net)):
            own, use = topo[net][l]
            for path in cgan.leaf_shapes(model, spec):
                if own.numel():
                    L[(l, "client", path)] = W[(net, l, "client", path)][own]
                if use.numel():
                    L[(l, "server", path)] = W[(net, l, "server", path)]
        leaves[net] = L
    ref = cgan.SplitGAN(model, leaves["G"], leaves["D"], topo["G"],
                        topo["D"], K)
    g = torch.Generator().manual_seed(0)
    batch = {"z": torch.randn(K, b, 100, generator=g),
             "fake_y": torch.randint(0, 10, (K, b), generator=g),
             "real_img": torch.rand(K, b, 1, 28, 28, generator=g) * 2 - 1,
             "real_y": torch.randint(0, 10, (K, b), generator=g)}
    with FlopCounterMode(display=False) as fc:
        ref.step(batch)
    g_mac, d_mac = counts.layer_macs(model, "G"), counts.layer_macs(model, "D")
    emb_in = model["generator"][0]["embed_dim"] / model["generator"][0]["in_dim"]
    # products the reference computes beyond the step's need, per image:
    # the first layers' input gradients are needed for the label
    # embeddings' channel alone (D's: 1 of 2 channels; G's: 10 of 110
    # inputs), and in the G update for D's image channel alone
    beyond = {
        "d_step: D layer 0 input gradient, image channel (real, fake)":
            2 * 2 * d_mac[0] / 2,
        "g_step: D layer 0 input gradient, label channel": 2 * d_mac[0] / 2,
        "g_step: G layer 0 input gradient, z inputs":
            2 * g_mac[0] * (1 - emb_in),
    }
    want = counts.step_flops_per_image(model)["total"] + sum(beyond.values())
    assert fc.get_total_flops() == pytest.approx(K * b * want, rel=1e-12)


def test_step_flops_per_image_is_table_3s():
    model = registry.cell(registry.load(), "gan100-train")["config"]["model"]
    g, d = counts.layer_macs(model, "G"), counts.layer_macs(model, "D")
    assert sum(g) == 110 * 12544 + 49 * 256 * 128 * 16 + 196 * 128 * 128 * 9 \
        + 196 * 128 * 64 * 16 + 784 * 64 * 9
    assert sum(d) == 196 * 2 * 64 * 16 + 49 * 64 * 128 * 16 \
        + 49 * 128 * 128 * 9 + 16 * 128 * 256 * 16 + 4096
    assert 0.9e9 < counts.step_flops_per_image(model)["total"] < 1.1e9
