"""PyTorch/CUDA port of scene_graph_commonsense_tpu.

The JAX package stays the reference; this package mirrors its module names
and imports nothing of it (nor jax, flax or optax).  Slice 1 covers PredCLS
evaluation and serving: train/engine.make_eval_step, eval/engines.run_eval_pc
and inference.SceneGraphPredictor, with the pair-assembly step running as a
hand-written CUDA kernel (ops/pair_pool.py, csrc/pair_pool.cu).
"""
