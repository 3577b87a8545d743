"""The paper's own experiment config: HFL over NOMA on MNIST-scale data.

64 clients, 4 edge servers, N_m = 4 clients admitted per edge server per
round (paper §V), a 784→128→128→10 MLP classifier, synthetic MNIST-like
data, IID or Dirichlet non-IID partitions.  Field for field the same
numbers as the reference package's ``configs/hfl_mnist.py``.
"""
import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HFLConfig:
    name: str = "hfl-mnist"
    # topology (paper §V)
    n_clients: int = 64
    n_edges: int = 4
    clients_per_edge: int = 4          # N_m
    area_side_m: float = 500.0
    semi_sync_fraction: float = 0.5    # M_c / M edge servers per cloud round
    # learning
    input_dim: int = 784
    hidden: int = 128
    n_classes: int = 10
    lr: float = 0.01                   # η (paper Table II)
    local_batch: int = 32
    local_accuracy_theta: float = 0.5  # θ
    edge_accuracy_xi: float = 0.5      # ξ
    mu_const: float = 2.0              # μ in τ₁ = μ log(1/θ)
    delta_const: float = 2.0           # δ in τ₂ = δ log(1/ξ)/(1-θ)
    # wireless (paper Table II)
    bandwidth_hz: float = 1e6
    carrier_hz: float = 1e9
    noise_dbm_per_hz: float = -174.0
    path_loss_exponent: float = 3.76
    p_min_w: float = 0.01
    p_max_w: float = 0.1
    cycles_per_sample: float = 1e7     # c_n
    capacitance: float = 1e-28         # β_n
    f_min_hz: float = 1e9
    f_max_hz: float = 10e9
    model_size_bits: float = 1e6       # d_n = 1 Mbit
    edge_model_size_bits: float = 1e6  # d_m
    edge_rate_bps: float = 20e6        # R_m (OFDMA edge->cloud)
    edge_power_w: float = 1.0          # p_m
    lambda_t: float = 0.5
    lambda_e: float = 0.5
    # data heterogeneity
    min_samples: int = 200
    max_samples: int = 1200
    dirichlet_alpha: float = 0.5
    data_noise: float = 0.9            # synthetic class-template noise

    @property
    def tau1(self) -> int:
        return max(1, round(self.mu_const
                            * math.log(1.0 / self.local_accuracy_theta)))

    @property
    def tau2(self) -> int:
        return max(1, round(self.delta_const
                            * math.log(1.0 / self.edge_accuracy_xi)
                            / (1.0 - self.local_accuracy_theta)))


CONFIG = HFLConfig()
