"""Measurement scripts of the port that run on the card (python -m
scene_graph_commonsense_torch.tools.<name>)."""
