"""list.txt parsing — `"name [fisheye_flag] [focal_px]"` per line.

Mirrors `ImageData::InitFromString` (`src/ImageData.cpp:186-290`): one token is
just a name; two tokens are name + fisheye flag; three tokens are
name + fisheye flag + initial focal estimate in pixels (0 focal on a 3-token
line means "no estimate").
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional


@dataclasses.dataclass
class ImageEntry:
    name: str
    fisheye: bool = False
    init_focal: float = 0.0

    @property
    def has_init_focal(self) -> bool:
        return self.init_focal > 0.0

    def key_name(self, key_directory: str = ".") -> str:
        """The image's key file: beside the image with `key_directory`
        ".", where ToSift writes it (`bin/ToSift.sh`; RunBundler.sh passes
        no --key_dir), else the image's base name in `key_directory`."""
        stem = os.path.splitext(self.name)[0]
        if key_directory == ".":
            return stem + ".key"
        return os.path.join(key_directory, os.path.basename(stem) + ".key")


def read_list_file(path: str, image_directory: str = ".") -> List[ImageEntry]:
    entries: List[ImageEntry] = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            name = toks[0]
            if image_directory != "." and not os.path.isabs(name):
                name = os.path.join(image_directory, name)
            fisheye = bool(int(toks[1])) if len(toks) > 1 else False
            focal = float(toks[2]) if len(toks) > 2 else 0.0
            entries.append(ImageEntry(name=name, fisheye=fisheye, init_focal=focal))
    return entries


def write_list_file(path: str, entries: List[ImageEntry]) -> None:
    with open(path, "w") as f:
        for e in entries:
            if e.has_init_focal:
                f.write(f"{e.name} {int(e.fisheye)} {e.init_focal:0.5f}\n")
            elif e.fisheye:
                f.write(f"{e.name} {int(e.fisheye)}\n")
            else:
                f.write(f"{e.name}\n")
