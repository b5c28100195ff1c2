"""Sessions for this slice: SyncTest and its builder (port of
``bevy_ggrs_tpu/session``)."""

from .builder import SessionBuilder
from .events import InputStatus, InvalidRequestError, MismatchedChecksumError
from .requests import AdvanceRequest, GgrsRequest, LoadRequest, SaveCell, SaveRequest
from .synctest import SyncTestSession

__all__ = [
    "SessionBuilder", "SyncTestSession", "InputStatus", "InvalidRequestError",
    "MismatchedChecksumError", "AdvanceRequest", "GgrsRequest", "LoadRequest",
    "SaveCell", "SaveRequest",
]
