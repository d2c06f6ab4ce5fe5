"""Logger setup, counterpart of `ucdir_tpu/utils/logging.py` (the port keeps
its own copy) — parity with core/logger.py:233-253:
'base' (file + optional screen) and 'val' (file) loggers; non-primary
processes silenced to ERROR."""
from __future__ import annotations

import logging
import os


def setup_logger(logger_name, root: str, phase: str,
                 level=logging.INFO, screen: bool = False,
                 process_index: int = 0):
    l = logging.getLogger(logger_name)
    formatter = logging.Formatter(
        '%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s',
        datefmt='%y-%m-%d %H:%M:%S')
    os.makedirs(root, exist_ok=True)
    fh = logging.FileHandler(os.path.join(root, '{}.log'.format(phase)),
                             mode='w')
    fh.setFormatter(formatter)
    if process_index != 0:
        l.setLevel('ERROR')
    else:
        l.setLevel(level)
    l.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        l.addHandler(sh)
