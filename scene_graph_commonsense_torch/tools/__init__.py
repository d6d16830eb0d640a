"""Tools of the port (python -m scene_graph_commonsense_torch.tools.<name>):
the card's measurement scripts, and the data tools: precompute_features (the
feature cache), sgrecords (SGRC records for the C++ packer) and make_mini_vg
(a miniature Visual Genome in the reference's on-disk format)."""
