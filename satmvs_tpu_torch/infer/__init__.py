"""Inference beyond one full-volume forward: slab-streaming tile forward
(`predict`), tiling (`tiling`) and whole-scene prediction (`scene`)."""
