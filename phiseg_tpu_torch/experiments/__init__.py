"""Named experiment registry (PyTorch port of phiseg_tpu/experiments; pure data).

One entry per reference experiment module (phiseg/experiments/*.py):
  phiseg_7_5         -- full hierarchy, R=7, L=5, zdim 2   (phiseg_7_5.py)
  phiseg_7_1         -- R=7, L=1                            (phiseg_7_1.py)
  probunet           -- prob U-Net, global zdim 6           (probunet.py)
  detunet            -- deterministic U-Net, annotator 0,
                        no KL, log dir 'lidc2'              (detunet.py)
  *_1annot           -- single-annotator variants (annotator_range=[0])
  hpunet             -- the Hierarchical Probabilistic U-Net (Kohl et al.
                        2019) at its published widths: R=8, n0=24, four
                        latent levels of zdim 1, no norm, GECO training
                        (deepmind-research hierarchical_probabilistic_unet/
                        model.py defaults); batch 12 as the LIDC jobs above,
                        Adam at 1e-4: at their 1e-3 the unnormalised net's
                        loss leaves its range within 10 steps at full width
                        (non-finite by step 20 in bf16). The JAX package has
                        no such entry.
  ssn                -- Stochastic Segmentation Networks (Monteiro et al.
                        2020): a rank-10 (zdim0) Gaussian over the logits on
                        the deterministic U-Net above (R=7, n0=32, batch
                        norm), 20 Monte Carlo samples in the loss (biomedia-
                        mira/stochastic_segmentation_networks ssn/ssn.py);
                        batch 12 and Adam 1e-3 as the LIDC jobs above; no KL
                        term. The JAX package has no such entry.

plus `*_synth` variants of each that swap LIDC for the in-memory synthetic
dataset (no reference equivalent; used by tests/bench and for running
without the LIDC download).
"""

from __future__ import annotations

from typing import Dict

from phiseg_tpu_torch.engine.config import ExperimentConfig


def _base(**kw) -> ExperimentConfig:
    return ExperimentConfig(**kw)


_REGISTRY: Dict[str, ExperimentConfig] = {}


def _register(cfg: ExperimentConfig) -> ExperimentConfig:
    _REGISTRY[cfg.experiment_name] = cfg
    # synthetic-data twin
    synth = cfg.replace(
        experiment_name=cfg.experiment_name + "_synth",
        data_identifier="synthetic",
        log_dir_name=cfg.log_dir_name + "_synth",
    )
    _REGISTRY[synth.experiment_name] = synth
    return cfg


phiseg_7_5 = _register(_base(
    experiment_name="phiseg_7_5",
    model_family="phiseg",
    latent_levels=5,
    resolution_levels=7,
    zdim0=2,
))

phiseg_7_1 = _register(phiseg_7_5.replace(
    experiment_name="phiseg_7_1",
    latent_levels=1,
))

probunet = _register(_base(
    experiment_name="probunet",
    model_family="prob_unet",
    latent_levels=1,
    resolution_levels=7,
    zdim0=6,
))

detunet = _register(_base(
    experiment_name="detunet",
    log_dir_name="lidc2",
    model_family="det_unet",
    latent_levels=1,
    resolution_levels=7,
    zdim0=6,
    annotator_range=(0,),
    kl_divergence_loss_weight=None,
))

hpunet = _register(_base(
    experiment_name="hpunet",
    model_family="hpu_net",
    n0=24,
    resolution_levels=8,
    latent_levels=4,
    zdim0=1,
    norm="none",
    nlabels=2,
    lr_schedule={0: 1e-4},
))

ssn = _register(_base(
    experiment_name="ssn",
    model_family="ssn",
    latent_levels=1,
    resolution_levels=7,
    zdim0=10,
    kl_divergence_loss_weight=None,
))

phiseg_7_5_1annot = _register(phiseg_7_5.replace(
    experiment_name="phiseg_7_5_1annot", annotator_range=(0,),
))
phiseg_7_1_1annot = _register(phiseg_7_1.replace(
    experiment_name="phiseg_7_1_1annot", annotator_range=(0,),
))
probunet_1annot = _register(probunet.replace(
    experiment_name="probunet_1annot", annotator_range=(0,),
))


# -- multi-scale-ambiguity synthetic benchmark (round-3; no reference
# equivalent experiment, but the *claim* under test is the reference's
# headline "PHiSeg > ProbUNet on GED^2/S_NCC" (README.md:53-54), which needs
# data with multi-scale, spatially-independent annotator disagreement --
# see data/synthetic.py make_multiscale_arrays. Larger splits than the
# nested task: n_test=256 so the paired t-tests aren't resting on 32 images
# (the reference protocol evaluates ~1700, phiseg_test_quantitative.py:39).
_MS = dict(
    data_identifier="synthetic",
    synth_task="multiscale",
    synth_n_train=512,
    synth_n_val=64,
    synth_n_test=256,
)
for _name, _base_cfg in (
    ("phiseg_7_5_ms", phiseg_7_5),
    ("phiseg_7_1_ms", phiseg_7_1),
    ("probunet_ms", probunet),
    ("detunet_ms", detunet),
):
    _REGISTRY[_name] = _base_cfg.replace(
        experiment_name=_name,
        log_dir_name=_base_cfg.log_dir_name + "_ms",
        **_MS,
    )


# -- boundary-FIELD ambiguity benchmark (round-3 follow-up to the multiscale
# negative result): annotator disagreement is a smooth random 8x8-grid
# threshold field (64 conditional dims per annotator, unpredictable from the
# image) -- beyond a zdim=6 global latent's support, matched to PHiSeg's
# spatial latent grids. See data/synthetic.py make_boundary_field_arrays.
_BF = dict(
    data_identifier="synthetic",
    synth_task="bfield",
    synth_n_train=512,
    synth_n_val=64,
    synth_n_test=256,
)
for _name, _base_cfg in (
    ("phiseg_7_5_bf", phiseg_7_5),
    ("phiseg_7_1_bf", phiseg_7_1),
    ("probunet_bf", probunet),
    ("detunet_bf", detunet),
):
    _REGISTRY[_name] = _base_cfg.replace(
        experiment_name=_name,
        log_dir_name=_base_cfg.log_dir_name + "_bf",
        **_BF,
    )


# -- large-data bfield pair (round-4): the matched-budget bf quartet lost
# GED^2 to probunet a third time, and the flagship's validation GED U-turned
# after ~14.5k steps -- an overfitting signature: 24k steps x batch 12 over
# 512 train images is ~560 epochs, whereas the reference's LIDC regime is
# ~8.9k images x ~30 epochs (lidc_data_loader.py:46-106 split sizes,
# phiseg_7_5.py num_iter). This pair re-runs the decisive comparison with
# 8x the training data (~70 epochs) at the SAME 24k budget, isolating
# train-set size as the confounder behind the headline-claim failures.
_BFXL = dict(
    data_identifier="synthetic",
    synth_task="bfield",
    synth_n_train=4096,
    synth_n_val=64,
    synth_n_test=256,
)
for _name, _base_cfg in (
    ("phiseg_7_5_bfxl", phiseg_7_5),
    ("probunet_bfxl", probunet),
):
    _REGISTRY[_name] = _base_cfg.replace(
        experiment_name=_name,
        log_dir_name=_base_cfg.log_dir_name + "_bfxl",
        **_BFXL,
    )


def get_experiment(name: str) -> ExperimentConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown experiment {name!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def list_experiments():
    return sorted(_REGISTRY)
