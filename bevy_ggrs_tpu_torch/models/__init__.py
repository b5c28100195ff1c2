"""Example and benchmark models (port of ``bevy_ggrs_tpu/models``)."""

from . import box_game, fixed_point, stress, stress_soa

__all__ = ["box_game", "fixed_point", "stress", "stress_soa"]
