"""The reference's test files with no same-named twin on the port are
exactly those ``torch_mirror.NOT_MIRRORED`` lists (ROADMAP §1 queues
them): a twin added, or a reference file added, must update the list."""

import torch_mirror


def test_unmirrored_reference_files_are_listed():
    assert torch_mirror.unmirrored() == torch_mirror.NOT_MIRRORED
