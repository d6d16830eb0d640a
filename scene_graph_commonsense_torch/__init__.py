"""PyTorch/CUDA port of scene_graph_commonsense_tpu.

The JAX package stays the reference; this package mirrors its module names
and imports nothing of it (nor jax, flax or optax).  Ported: PredCLS
evaluation and serving (train/engine.make_eval_step, eval/engines.run_eval_pc,
inference.SceneGraphPredictor) and PredCLS training (train/engine.make_train_step,
train/loop.fit, bench.py), with the pair-assembly step and its gradient
running as hand-written CUDA kernels (ops/pair_pool.py, csrc/pair_pool.cu).
"""
