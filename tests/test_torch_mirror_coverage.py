"""Every reference test file has its same-named twin on the port:
``torch_mirror.NOT_MIRRORED`` is empty, and the directory agrees, so a
reference file added without a twin fails here."""

import torch_mirror


def test_unmirrored_reference_files_are_listed():
    assert torch_mirror.unmirrored() == torch_mirror.NOT_MIRRORED
