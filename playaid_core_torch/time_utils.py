"""Frame <-> timestamp helpers: the port's own copy of
``playaid_core_tpu/time_utils.py`` (reference: time_utils.py:1-17; 60 fps log)."""


def timestamp_to_frame(timestamp: str) -> int:
    minutes, seconds = timestamp.split(":")
    return (int(seconds) * 60) + (int(minutes) * 60 * 60)


def frame_to_timestamp(frame_number: int, fps: int = 60) -> str:
    total_seconds = frame_number // fps
    return f"{total_seconds // 60:02}:{total_seconds % 60:02}"


def frame_to_seconds(frame_number: int, fps: int = 60) -> int:
    return frame_number // fps
