"""The benchmark's frozen scenario against the port's generator: which
labels each client misses, and a client's labels for its size."""
import numpy as np

from portbench import scenario
from portbench import program  # noqa: F401  (puts the port on the path)
from repro_torch.data import partition, synthetic


def test_exclusions_and_labels_are_the_ports():
    for seed in (0, 3, 2 ** 31 + 11):
        for g in (0, 1):
            plan = [(10, 2), (3, 3), (3, 4)]
            assert scenario.exclusion_plan(50, plan, seed + g) == \
                partition.paper_exclusion_plan(50, plan, seed + g)
        excl = [2, 7]
        raw = int(600 * (1.0 + 0.25 * len(excl) + 0.2)) + 8
        for dom in ("gratings", "blobs"):
            _, labs = synthetic.make_dataset(dom, raw, seed=seed * 10007 + 5)
            labs = labs[~np.isin(labs, excl)][:600]
            np.testing.assert_array_equal(
                scenario.client_labels(dom, raw, excl, 600,
                                       seed * 10007 + 5), labs)


def test_clients_hold_the_scenarios_sizes_and_domains():
    clients = scenario.build("2dom_noniid", 8, 12, 28, 5)
    assert [d for d, _, _ in clients] == ["gratings"] * 4 + ["blobs"] * 4
    assert sorted(len(l) for _, _, l in clients) == [8] * 4 + [12] * 4
    for _, x, l in clients:
        assert x.shape == (len(l), 28, 28, 1) and x.dtype == np.float32
        assert -1.0 <= x.min() and x.max() <= 1.0
