"""Run-completion notification.

Port of ``lfit_python_tpu/utils/notify.py``.  Channels, tried in order of
configuration:
  * ``cmd``   — a shell command; the message is piped to its stdin (wire
    it to mail(1), a chat client, ...);
  * ``file``  — append a JSON line to a file (works without a network);
  * ``email`` — SMTP through localhost, where a mail transfer agent runs.
Every failure is swallowed: a notification never fails a finished run.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

__all__ = ["notify"]


def notify(subject: str, body: str, *, cmd=None, file=None, email=None):
    """Send a completion notification through every configured channel.
    Returns the list of channels that succeeded."""
    ok = []
    if cmd:
        try:
            subprocess.run(cmd, shell=True, input=f"{subject}\n{body}",
                           text=True, timeout=60, check=True,
                           capture_output=True)
            ok.append("cmd")
        except Exception:
            pass
    if file:
        try:
            with Path(file).open("a") as fh:
                fh.write(json.dumps(
                    {"t": time.time(), "subject": subject, "body": body})
                    + "\n")
            ok.append("file")
        except Exception:
            pass
    if email:
        try:
            import smtplib
            from email.message import EmailMessage

            msg = EmailMessage()
            msg["Subject"] = subject
            msg["To"] = email
            msg["From"] = "lfit_python_tpu_torch@localhost"
            msg.set_content(body)
            with smtplib.SMTP("localhost", timeout=10) as s:
                s.send_message(msg)
            ok.append("email")
        except Exception:
            pass
    return ok
