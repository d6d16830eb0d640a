"""Typed configuration, a copy of scene_graph_commonsense_tpu/config.py.

The port keeps its own copy so that it imports nothing of the JAX package;
both packages read the same YAML schema.  Knobs that only the JAX package
acts on (fused_backbone, flash_encoder, the TPU precision knobs, the
profiler window) are kept so that one config file serves both.

Mirrors the knob set of the reference's config.yaml (reference config.yaml:1-74)
and the dataset-dependent derived values patched in its CLI
(reference main.py:49-85), but as frozen dataclasses with validation instead of
an untyped nested dict threaded positionally through every function.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Cluster-size table: supercat_clustering -> (num_geometric, num_possessive,
# num_semantic).  'motif' follows the Neural-Motifs super-category definitions;
# the other entries are the KMeans(k=3) cluster sizes over GPT-2 / BERT / CLIP
# predicate-name embeddings (reference main.py:56-71, token_embeddings.py).
CLUSTER_SIZES = {
    "motif": (15, 11, 24),
    "gpt2": (9, 32, 9),
    "bert": (12, 25, 13),
    "clip": (27, 15, 8),
}

RUN_MODES = ("train", "eval", "prepare_cs", "train_cs", "eval_cs")
EVAL_MODES = ("pc", "sgc", "sgd")
DATASETS = ("vg", "oiv6")


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "vg"                      # 'vg' | 'oiv6'
    supcat_clustering: str = "motif"         # 'motif' | 'gpt2' | 'bert' | 'clip'
    image_dir: str = "datasets/vg/images"
    annot_dir: str = "datasets/vg_scene_graph_annot"
    annotation_train: str = "datasets/vg/annotations/instances_vg_train.json"
    annotation_test: str = "datasets/vg/annotations/instances_vg_test.json"
    artifacts_dir: str = "datasets/artifacts"  # npz triplet tables etc.
    # Optional cache of frozen-DETR feature maps (one *_features.npz per
    # image, tools/precompute_features.py); empty = encode per batch.
    features_dir: str = ""
    # OIv6 precomputed depth maps (one <img_fn>_depth.npz per image,
    # tools/prepare_depth_oiv6.py — reference dataset_utils.py:203-228);
    # empty = zero depth.  VG bakes depth into its annotation npz instead.
    depth_dir: str = ""
    # SGRC binary records for the C++ batch packer (tools/preprocess_vg.py
    # --stage sgrecords).  When set (VG, eval-style runs, features_dir
    # required), batches are assembled by the native thread-pool packer
    # (data/pipeline.NativeRecordPipeline) instead of the Python loader.
    sgrc_dir: str = ""
    area_frac_thresh: float = 0.002
    percent_train: float = 1.0
    percent_test: float = 1.0
    # Static pair-grid geometry: images with <2 or >max_objects objects are
    # dropped (reference dataloader.py:119); everything else is padded to
    # max_objects and expressed with validity masks.
    max_objects: int = 20
    # Detection view (SGCLS/SGDET): min-side-`nonsq_min_side` resize onto a
    # fixed `nonsq_canvas` square canvas + pixel mask — the static-shape
    # analogue of the reference's per-batch NestedTensor padding
    # (dataloader.py:40-41 Resize(600, max_size=1000) + utils.py:185-204).
    # The fixed canvas is a DOCUMENTED deviation: a padded-and-masked
    # 1000x1000 run is not bit-identical to an unpadded variable-size one
    # (different conv grid phase + masked-attention geometry).  Parity
    # harnesses on uniform-size fixtures set nonsq_canvas to the exact
    # resize output so the canvas carries no padding and the two
    # frameworks see identical tensors (tools/detection_parity.py).
    nonsq_min_side: int = 600
    nonsq_canvas: int = 1000


@dataclass(frozen=True)
class ModelConfig:
    image_size: int = 1024
    feature_size: int = 32
    num_img_feature: int = 256
    num_classes: int = 150
    num_relations: int = 50
    num_super_classes: int = 17
    hidden_dim: int = 128
    use_depth: bool = True
    hierarchical_pred: bool = True
    topk_cat: int = 2
    nms_iou: float = 0.5
    num_geometric: int = 15
    num_possessive: int = 11
    num_semantic: int = 24
    # Bayesian-head temperatures (reference model.py:134-136).
    T1: float = 1.0
    T2: float = 1.0
    T3: float = 1.0
    dropout_rate: float = 0.5
    llm_model: str = "gpt3.5"                # 'gpt3.5' | 'gpt4v'
    # Compute dtype for the relation trunk ('float32' for parity tests,
    # 'bfloat16' for production throughput; params stay float32).
    compute_dtype: str = "bfloat16"
    # Fused Pallas bottleneck path for the frozen ResNet trunk
    # ('auto' = on for single-device TPU, 'on', 'off').  See
    # models/resnet_fused.py; GSPMD-sharded multi-chip eval keeps the
    # plain XLA path until the kernel is wrapped in shard_map.
    fused_backbone: str = "auto"
    # "auto" | "on" | "off": Pallas flash (online-softmax) DETR encoder
    # self-attention — auto = on-TPU and compute_dtype != float64 (the
    # f64 parity harnesses keep the naive exact-softmax path).
    flash_encoder: str = "auto"
    detr_pretrained: str = "checkpoints/detr101_vg.msgpack"
    # GloVe label-embedding table for the pnp context models
    # (tools/glove_embeddings.py); absent file -> learned init.
    glove_embeddings: str = "datasets/artifacts/glove_labels_vg.npz"
    # Detector geometry (production = DETR-ResNet101, reference
    # utils.py:88-120).  Parity/test harnesses shrink these to run the
    # REAL detection chain at tractable CPU cost
    # (tools/detection_parity.py).
    detr_blocks: tuple = (3, 4, 23, 3)
    detr_enc_layers: int = 6
    detr_dec_layers: int = 6


@dataclass(frozen=True)
class TrainConfig:
    run_mode: str = "train"                  # see RUN_MODES
    eval_mode: str = "pc"                    # see EVAL_MODES
    learning_rate: float = 1e-5
    weight_decay: float = 1e-4
    momentum: float = 0.9
    batch_size: int = 12
    num_epoch: int = 3
    start_epoch: int = 0
    continue_train: bool = False
    # Step-decay epochs, lr *= 0.1 at each (reference train_test.py:138-139).
    scheduler_epochs: Tuple[int, int] = (2, 5)
    test_epoch: int = 2
    checkpoint_path: str = "checkpoints/"
    result_path: str = "results/"
    # Loss weights (reference config.yaml:63-69).
    lambda_contrast: float = 1.0
    lambda_connectivity: float = 0.1
    lambda_not_connected: float = 1.0
    lambda_commonsense: float = 1.0
    lambda_cs_weak: float = 0.1
    lambda_cs_strong: float = 10.0
    # 0 = off (reference parity); >0 adds global-norm gradient clipping
    grad_clip_norm: float = 0.0
    # Precision knobs (TPU-first additions, both default to reference-
    # equivalent f32): 'bfloat16' halves the SGD momentum buffer's HBM
    # traffic / the gradient all-reduce's ICI traffic respectively.
    momentum_dtype: str = "float32"
    grad_allreduce_dtype: str = "float32"
    print_freq: int = 100
    eval_freq: int = 100
    print_freq_test: int = 20
    eval_freq_test: int = 1
    save_vis_results: bool = False
    # Static capacity of the packed pair buffer per global batch.  Every valid
    # directed pair of a batch is compacted into this buffer; 0 means "full
    # worst case" = batch_size * max_objects * (max_objects - 1).
    pair_capacity: int = 0
    # Capacity of the contrastive (augmented-view) pair buffer, which holds
    # only CONNECTED pairs (reference train_utils.py:96-99 feeds SupCon
    # nothing else).  Connected pairs are GT relations — on VG ~6 per image,
    # i.e. an order of magnitude sparser than valid pairs — so the default
    # 0 = pair_capacity // 4 still leaves ~2x headroom over observed batch
    # maxima; overflow drops the excess pairs from the (regularizing)
    # contrastive term only, never from the main losses.
    aug_pair_capacity: int = 0
    # Reference-faithful training dynamics (parity mode, default off):
    # per-column loss means with the connectivity rebinding, triangular
    # re-accumulation weighting, the reference's typo'd class-weight table,
    # and the dynamic LR ~ sqrt(live fraction) left in effect at step time
    # (reference train_test.py:192, 219-258; train_utils.py:70-92;
    # utils.py:258-263).  See train/losses.faithful_losses.
    faithful_dynamics: bool = False
    # SGCLS parity: replicate the reference's top-2 tie duplication when
    # matching predicted labels onto GT boxes (reference utils.py:404-415)
    # instead of the single best-IoU slot.
    sgcls_top2_duplicates: bool = False
    # Eval-target parity (deviation 4, reference evaluate.py:152-157 /
    # train_test.py:402-409): when a whole ragged pair column fails the
    # mask-overlap filter across the batch, the reference `continue`s past
    # BOTH directions, so those GT pairs never enter the R@k denominator.
    # Default counts every connected GT pair; this restores the
    # batch-composition-dependent drops (eval/builders.eval_column_keep).
    faithful_eval_targets: bool = False
    # SGDET target parity (reference utils.py:305-313): match_target_sgd's
    # off-by-one loop bound never visits the last object's relation row,
    # dropping every GT pair involving an image's final object from the
    # SGDET target set.  Default keeps them; this restores the drop
    # (eval/builders.sgd_target_keep).
    faithful_sgd_targets: bool = False
    # Host input pipeline: number of batches kept in flight by a background
    # producer thread (data/pipeline.prefetch_iterator); loading, DETR
    # featurization, and host->device transfer overlap the train step.
    # 0 = synchronous loading (the reference's num_workers=0 behavior,
    # reference train_test.py:52).
    prefetch_batches: int = 2
    seed: int = 0
    # Observability (SURVEY.md §5).  TensorBoard scalars mirror the
    # reference's tag set (train_test.py:279-285); profile_start_step >= 0
    # opens a jax.profiler trace window of profile_num_steps steps.
    tensorboard: bool = False
    tensorboard_dir: str = "results/tb"
    profile_dir: str = ""
    profile_start_step: int = -1
    profile_num_steps: int = 5


@dataclass(frozen=True)
class ParallelConfig:
    # Mesh axis sizes; data-parallel batch sharding over 'data', optional
    # tensor parallelism of the wide fc1/fc2 layers over 'model'.
    data_axis: int = -1                      # -1: use all devices
    model_axis: int = 1


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def __post_init__(self):
        if self.data.dataset not in DATASETS:
            raise ValueError(f"unknown dataset {self.data.dataset!r}")
        if self.training.run_mode not in RUN_MODES:
            raise ValueError(f"unknown run_mode {self.training.run_mode!r}")
        if self.training.eval_mode not in EVAL_MODES:
            raise ValueError(f"unknown eval_mode {self.training.eval_mode!r}")
        if self.data.supcat_clustering not in CLUSTER_SIZES:
            raise ValueError(
                f"unknown supcat_clustering {self.data.supcat_clustering!r}")
        ng, np_, ns = (self.model.num_geometric, self.model.num_possessive,
                       self.model.num_semantic)
        if ng + np_ + ns != self.model.num_relations:
            raise ValueError(
                f"branch sizes {ng}+{np_}+{ns} != num_relations "
                f"{self.model.num_relations}")

    @property
    def pair_capacity(self) -> int:
        cap = self.training.pair_capacity
        if cap <= 0:
            n = self.data.max_objects
            cap = self.training.batch_size * n * (n - 1)
        return cap

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


def derive(dataset: str = "vg", supcat_clustering: str = "motif",
           hierarchical_pred: bool = True, run_mode: str = "train",
           eval_mode: str = "pc", **overrides) -> Config:
    """Builds a Config with the dataset/clustering-derived class counts.

    Mirrors reference main.py:49-85: VG = 150 classes / 50 relations / 17
    super-classes with clustering-dependent branch sizes; OIv6 = 601 classes /
    30 relations with (4, 2, 24) branches.
    """
    # dataset-derived values are DEFAULTS; an explicit 'model' override
    # (e.g. from YAML) wins instead of raising a duplicate-kwarg TypeError
    if dataset == "vg":
        ng, np_, ns = CLUSTER_SIZES[supcat_clustering]
        model_kwargs = dict(num_classes=150, num_relations=50,
                            num_super_classes=17, num_geometric=ng,
                            num_possessive=np_, num_semantic=ns,
                            hierarchical_pred=hierarchical_pred)
    elif dataset == "oiv6":
        model_kwargs = dict(num_classes=601, num_relations=30,
                            num_super_classes=17, num_geometric=4,
                            num_possessive=2, num_semantic=24,
                            hierarchical_pred=hierarchical_pred)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    model_kwargs.update(overrides.pop("model", {}))
    model = ModelConfig(**model_kwargs)
    data_overrides = overrides.pop("data", {})
    if dataset == "oiv6":
        # OIv6 default locations (reference config.yaml / SGTR layout);
        # explicit overrides still win
        data_overrides = {
            "image_dir": "datasets/open_image_v6/images",
            "annot_dir": "datasets/open_image_v6_annot",
            "annotation_train": "datasets/open_image_v6/annotations/"
                                "oiv6-adjust/vrd-train-anno.json",
            "annotation_test": "datasets/open_image_v6/annotations/"
                               "oiv6-adjust/vrd-test-anno.json",
            **data_overrides}
    data_kwargs = dict(dataset=dataset,
                       supcat_clustering=supcat_clustering)
    data_kwargs.update(data_overrides)
    data = DataConfig(**data_kwargs)
    training_kwargs = dict(run_mode=run_mode, eval_mode=eval_mode)
    training_kwargs.update(overrides.pop("training", {}))
    training = TrainConfig(**training_kwargs)
    parallel = ParallelConfig(**overrides.pop("parallel", {}))
    if overrides:
        raise ValueError(f"unknown config sections {sorted(overrides)}")
    return Config(data=data, model=model, training=training, parallel=parallel)


def load_config(path: Optional[str] = None, **cli_overrides) -> Config:
    """Loads a YAML config file (same schema as derive()'s kwargs) if given,
    then applies CLI-style overrides (run_mode / eval_mode / cluster /
    hierar), mirroring reference main.py:28-39."""
    kwargs = {}
    if path is not None:
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        kwargs.update(raw)
    for k, v in cli_overrides.items():
        if v is not None:
            kwargs[k] = v
    return derive(**kwargs)
