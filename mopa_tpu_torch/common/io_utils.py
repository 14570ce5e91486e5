"""Small IO helpers (port of ``mopa_tpu/common/io_utils.py``)."""

import hashlib


def get_md5(filename):
    """The hex MD5 digest of a file, read in 1 MiB chunks."""
    hash_obj = hashlib.md5()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            hash_obj.update(chunk)
    return hash_obj.hexdigest()
