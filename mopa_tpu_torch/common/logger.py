"""Colored console + file logger (port of ``mopa_tpu/common/logger.py``).

A cached setup per logger name, the root name abbreviated on the console,
colored WARNING/ERROR tags there, and a plain-text mirror in a log file: the
same format and file layout as the JAX package's.
"""

import functools
import logging
import os
import sys

_FORMAT = "[%(asctime)s] %(name)s %(levelname)s: %(message)s"
_DATEFMT = "%m/%d %H:%M:%S"


class _ColorfulFormatter(logging.Formatter):
    COLORS = {"WARNING": "\033[33m", "ERROR": "\033[31m\033[4m",
              "CRITICAL": "\033[31m\033[4m"}
    RESET = "\033[0m"

    def __init__(self, fmt, datefmt, root_name="", abbrev_name=""):
        self._root_name = root_name + "."
        self._abbrev_name = (abbrev_name + ".") if abbrev_name else ""
        super().__init__(fmt, datefmt)

    def formatMessage(self, record):
        record.name = record.name.replace(self._root_name, self._abbrev_name)
        log = super().formatMessage(record)
        color = self.COLORS.get(record.levelname)
        if color:
            prefix = color + record.levelname + self.RESET
            log = log.replace(record.levelname, prefix, 1)
        return log


@functools.lru_cache()
def setup_logger(name="mopa_tpu_torch", output=None, *, color=True,
                 abbrev_name=None):
    """The logger ``name`` at DEBUG, printing to stdout and, with
    ``output``, to a file: ``output`` itself when it ends in ``.txt`` or
    ``.log``, else ``output/log.txt``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if abbrev_name is None:
        abbrev_name = name

    plain_formatter = logging.Formatter(_FORMAT, datefmt=_DATEFMT)
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    if color:
        ch.setFormatter(_ColorfulFormatter(_FORMAT, datefmt=_DATEFMT,
                                           root_name=name,
                                           abbrev_name=abbrev_name))
    else:
        ch.setFormatter(plain_formatter)
    logger.addHandler(ch)

    if output is not None:
        filename = output
        if not (output.endswith(".txt") or output.endswith(".log")):
            filename = os.path.join(output, "log.txt")
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(plain_formatter)
        logger.addHandler(fh)
    return logger


def get_logger(output=None, abbrev_name="MoPA"):
    """The package's logger, as the JAX package's ``get_logger`` sets it
    up."""
    return setup_logger("mopa_tpu_torch", output, abbrev_name=abbrev_name)
