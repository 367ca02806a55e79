"""File-descriptor-level capture of stdout/stderr into a log file (a copy of
`gluefactory_tpu/utils/stdout_capturing.py`): training runs tee console
output to `<exp>/log.txt`, periodically cleaning carriage returns and
backspaces from progress bars."""

from __future__ import annotations

import contextlib
import os
import re
import subprocess
import sys
import threading
import time


def flush():
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except (AttributeError, ValueError, OSError):
        pass


def apply_backspaces_and_linefeeds(text: str) -> str:
    """Interpret \\r and \\b as a terminal would."""
    orig_lines = text.split("\n")
    orig_lines_len = len(orig_lines)
    new_lines = []
    for orig_line_idx, orig_line in enumerate(orig_lines):
        chars, cursor = [], 0
        orig_line_len = len(orig_line)
        for orig_char_idx, orig_char in enumerate(orig_line):
            if orig_char == "\r" and (
                orig_char_idx != orig_line_len - 1 or orig_line_idx != orig_lines_len - 1
            ):
                cursor = 0
            elif orig_char == "\b":
                cursor = max(0, cursor - 1)
            else:
                if orig_char == "\r":
                    cursor = len(chars)
                if cursor == len(chars):
                    chars.append(orig_char)
                else:
                    chars[cursor] = orig_char
                cursor += 1
        new_lines.append("".join(chars))
    return "\n".join(new_lines)


@contextlib.contextmanager
def capture_outputs(filename):
    """Duplicate fd 1/2 through `tee` into `filename`; clean escapes every
    120 s and at exit."""
    flush()
    target = open(filename, "a+")
    original_stdout_fd = os.dup(1)
    original_stderr_fd = os.dup(2)

    tee_stdout = subprocess.Popen(
        ["tee", "-a", "-i", filename], start_new_session=True,
        stdin=subprocess.PIPE, stdout=1,
    )
    tee_stderr = subprocess.Popen(
        ["tee", "-a", "-i", filename], start_new_session=True,
        stdin=subprocess.PIPE, stdout=2,
    )
    os.dup2(tee_stdout.stdin.fileno(), 1)
    os.dup2(tee_stderr.stdin.fileno(), 2)

    stop_cleaner = threading.Event()

    def cleanup_loop():
        while not stop_cleaner.wait(120):
            _clean(filename)

    def _clean(fname):
        try:
            with open(fname, "r") as f:
                text = f.read()
            with open(fname, "w") as f:
                f.write(apply_backspaces_and_linefeeds(text))
        except OSError:
            pass

    cleaner = threading.Thread(target=cleanup_loop, daemon=True)
    cleaner.start()
    try:
        yield
    finally:
        flush()
        stop_cleaner.set()
        tee_stdout.stdin.close()
        tee_stderr.stdin.close()
        os.dup2(original_stdout_fd, 1)
        os.dup2(original_stderr_fd, 2)
        tee_stdout.wait(timeout=1)
        tee_stderr.wait(timeout=1)
        os.close(original_stdout_fd)
        os.close(original_stderr_fd)
        _clean(filename)
        target.close()
