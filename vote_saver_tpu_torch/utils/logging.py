"""Protocol logging: the log/logln + DISABLE_OUTPUT replacement.

The reference uses variadic stdout printers gated by a compile-time
DISABLE_OUTPUT switch (common.hpp:131-145).  Here: standard logging with an
env-var gate (VSTPU_QUIET=1) and structured key=value support for the
metrics the reference lacks.
"""

from __future__ import annotations

import logging
import os
import sys

_logger = logging.getLogger("vote_saver_tpu")
if not _logger.handlers:
    h = logging.StreamHandler(sys.stdout)
    h.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(h)
    _logger.setLevel(logging.CRITICAL if os.environ.get("VSTPU_QUIET") == "1" else logging.INFO)


def log(*args):
    _logger.info(" ".join(str(a) for a in args))


def logln(*args):
    log(*args)


def log_metric(name: str, value, unit: str = ""):
    _logger.info("metric %s=%s%s", name, value, unit and f" {unit}")
