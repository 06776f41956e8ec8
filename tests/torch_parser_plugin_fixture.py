"""A parser plugin for the PyTorch port's ParserPluginManager (≙ a
site-specific CustomParser — here an importable Python factory).  It
builds the port's SlotRecordBlock and imports nothing else of either
package."""

import numpy as np

from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock


class _FirstTokenParser:
    """One record per line: each line's first token is the one feasign of
    the config's first slot."""

    def __init__(self, config):
        self.config = config

    def parse_block(self, lines):
        keys = np.array([int(line.split()[0]) for line in lines], np.uint64)
        return SlotRecordBlock(
            n=len(lines),
            uint64_slots={self.config.slots[0].name:
                          (keys, np.arange(len(lines) + 1, dtype=np.int64))})


def create_parser(config):
    return _FirstTokenParser(config)


def other_factory(config):
    return _FirstTokenParser(config)
