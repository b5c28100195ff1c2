"""Example and benchmark models (port of ``bevy_ggrs_tpu/models``)."""

from . import box_game, crowd, fixed_point, particles, pong, stress, stress_soa

__all__ = ["box_game", "crowd", "fixed_point", "particles", "pong", "stress", "stress_soa"]
