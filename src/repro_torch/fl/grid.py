"""The paper's §6 comparison as data: the algorithm grid of Tables 1-2 and
the two experiment protocols, the port's copy of ``benchmarks/common.py``'s
``ALGORITHMS`` and of the settings in ``benchmarks/bench_table1_fashion.py``
and ``benchmarks/bench_table2_cifar.py``. ``chip_smoke.py`` and the tests
read it."""

from __future__ import annotations

import dataclasses

from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.data.synthetic import ImageDataConfig
from repro_torch.fl.simulation import FLConfig

#: the §6 algorithm grid (Tables 1-2); noisy signSGD's budget is its sigma
ALGORITHMS = {
    "signSGD": CompressionConfig(compressor="sign", server="majority_vote"),
    "scaled_signSGD": CompressionConfig(compressor="scaled_sign", server="mean"),
    "noisy_signSGD": CompressionConfig(compressor="noisy_sign",
                                       budget=BudgetConfig(value=0.01),
                                       server="majority_vote"),
    "qsgd_1bit_l2": CompressionConfig(compressor="qsgd_1bit_l2", server="mean"),
    "qsgd_1bit_linf": CompressionConfig(compressor="qsgd_1bit_linf", server="mean"),
    "terngrad": CompressionConfig(compressor="terngrad", server="mean"),
    "sparsignSGD_B1": CompressionConfig(compressor="sparsign",
                                        budget=BudgetConfig(value=1.0),
                                        server="majority_vote"),
    "ef_sparsignSGD": CompressionConfig(compressor="sparsign",
                                        budget=BudgetConfig(value=1.0),
                                        server="scaled_sign_ef"),
}


@dataclasses.dataclass(frozen=True)
class Protocol:
    """One table's experiment: model, data, partition and round settings."""

    name: str
    model: str                  # fl.models constructor: mlp_fashion | cnn_cifar
    data: ImageDataConfig
    n_workers: int
    alpha: float                # Dirichlet label skew of the partition
    partition_seed: int
    model_seed: int
    participation: float
    batch_size: int
    lr: float
    rounds: int
    seed: int
    eval_every: int
    target: float               # accuracy whose rounds and bits the table reports

    def fl_config(self, comp: CompressionConfig, **overrides) -> FLConfig:
        kw = dict(n_workers=self.n_workers, participation=self.participation,
                  rounds=self.rounds, batch_size=self.batch_size, lr=self.lr, comp=comp,
                  seed=self.seed, eval_every=self.eval_every)
        kw.update(overrides)
        return FLConfig(**kw)


#: Table 1: Fashion-MNIST-like data, Dir(0.1), full participation, the MLP
TABLE1 = Protocol(
    name="table1", model="mlp_fashion",
    data=ImageDataConfig(n_train=10000, n_test=1000, seed=0),
    n_workers=50, alpha=0.1, partition_seed=0, model_seed=0, participation=1.0,
    batch_size=64, lr=0.05, rounds=150, seed=0, eval_every=5, target=0.70)

#: Table 2: CIFAR-10-like data, Dir(0.5), 20% participation, the CNN
TABLE2 = Protocol(
    name="table2", model="cnn_cifar",
    data=ImageDataConfig(n_classes=10, shape=(32, 32, 3), n_train=6000, n_test=500,
                         noise=1.0, seed=1),
    n_workers=20, alpha=0.5, partition_seed=1, model_seed=1, participation=0.2,
    batch_size=32, lr=0.03, rounds=120, seed=1, eval_every=5, target=0.55)
