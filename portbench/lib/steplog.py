"""The engine's step log (``repro_torch.serving.spans``) over the window:
``drive_serve.run`` calls ``step()`` once per step it records and never
after the window, so the window is the log's last ``engine_steps``
records.  A program without the log reads as nothing."""

from __future__ import annotations

from typing import Optional


def window(r: dict) -> Optional[dict]:
    try:
        from repro_torch.serving.spans import window as steps_window
    except ImportError:
        return None
    return steps_window(r.get("engine_steps") or 0)
