"""Track building — connected components of the match graph.

Mirrors `ComputeTracks` (`src/ComputeTracks.cpp:36-313`): BFS from each
unvisited keypoint over the SYMMETRIC, double-match-pruned match lists, with
the reference's "one feature per image per track" rule (an image is marked the
first time any of its keys joins the track; later keys from that image are
not added — `img_marked`, `ComputeTracks.cpp:171,210`).  Tracks need >= 2
views (`:256`).

Outputs the same per-image structures the reference keeps: for every image a
list of (track, key) incidences (`m_visible_points` / `m_visible_keys`,
`ComputeTracks.cpp:294-304`).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import numpy as np

Track = List[Tuple[int, int]]  # [(image, key), ...]


def build_tracks(
    matches: Dict[Tuple[int, int], np.ndarray],
    num_images: int,
) -> List[Track]:
    """matches must be symmetric ((i,j) and (j,i) present) and one-to-one per
    direction (PruneDoubleMatches applied)."""
    # match_map[(i, j)]: key-in-i -> key-in-j  (first match wins, like the
    # reference's sorted-list binary search that returns the first hit).
    match_map: Dict[Tuple[int, int], Dict[int, int]] = {}
    neighbors: Dict[int, List[int]] = collections.defaultdict(list)
    for (i, j), m in matches.items():
        d: Dict[int, int] = {}
        for a, b in m:
            if int(a) not in d:
                d[int(a)] = int(b)
        match_map[(i, j)] = d
        neighbors[i].append(j)

    visited: Dict[int, set] = {i: set() for i in range(num_images)}
    tracks: List[Track] = []

    for i in range(num_images):
        if not neighbors[i]:
            continue
        nbr_i = neighbors  # alias
        # Iterate keys in ascending order, like the reference's key loop.
        all_keys = sorted(
            set(k for j in neighbors[i] for k in match_map[(i, j)].keys()))
        for f in all_keys:
            if f in visited[i]:
                continue
            visited[i].add(f)
            track: Track = [(i, f)]
            queue = collections.deque([(i, f)])
            img_marked = {i}
            while queue:
                img1, f1 = queue.popleft()
                for k in nbr_i[img1]:
                    if k in img_marked:
                        continue
                    idx2 = match_map[(img1, k)].get(f1)
                    if idx2 is None or idx2 in visited[k]:
                        continue
                    visited[k].add(idx2)
                    track.append((k, idx2))
                    queue.append((k, idx2))
                    img_marked.add(k)
            if len(track) >= 2:
                tracks.append(track)
    return tracks


def tracks_to_image_tables(
    tracks: Sequence[Track], num_images: int
) -> Tuple[List[List[int]], List[List[int]], List[Dict[int, int]]]:
    """Per-image (visible_points, visible_keys) lists plus key->track maps
    (the role of `SetTracks`, `src/MatchTracks.cpp:115`)."""
    visible_points: List[List[int]] = [[] for _ in range(num_images)]
    visible_keys: List[List[int]] = [[] for _ in range(num_images)]
    key_track: List[Dict[int, int]] = [dict() for _ in range(num_images)]
    for t, views in enumerate(tracks):
        for img, key in views:
            visible_points[img].append(t)
            visible_keys[img].append(key)
            key_track[img][key] = t
    return visible_points, visible_keys, key_track


def matches_from_tracks(
    tracks: Sequence[Track], i: int, j: int
) -> np.ndarray:
    """Key-index matches between images i, j implied by shared tracks
    (`SetMatchesFromTracks`, `src/MatchTracks.cpp:176-280`)."""
    keys_i = {}
    out = []
    for t, views in enumerate(tracks):
        ki = kj = None
        for img, key in views:
            if img == i:
                ki = key
            elif img == j:
                kj = key
        if ki is not None and kj is not None:
            out.append((ki, kj))
    return np.array(out, dtype=np.int32).reshape(-1, 2)


def num_track_matches(
    tracks: Sequence[Track],
    visible_points: Sequence[Sequence[int]], i: int, j: int
) -> int:
    """Number of shared tracks between two images
    (`GetNumTrackMatches`, `src/MatchTracks.cpp:148`)."""
    si = set(visible_points[i])
    return sum(1 for t in visible_points[j] if t in si)


def tracks_from_points(
    point_views: Sequence[Sequence[Tuple[int, int]]], num_images: int
) -> Tuple[List[Track],
           List[List[int]], List[List[int]], List[Dict[int, int]]]:
    """Rebuild tracks + per-image tables from bundle-adjusted point view
    lists (`CreateTracksFromPoints` + `SetTracksFromPoints`,
    `src/MatchTracks.cpp:61-113`).  Used when resuming from --bundle."""
    tracks: List[Track] = [list(map(tuple, v)) for v in point_views]
    vp, vk, kt = tracks_to_image_tables(tracks, num_images)
    return tracks, vp, vk, kt


def matches_from_points(
    point_views: Sequence[Sequence[Tuple[int, int]]],
    threshold: int = 0,
) -> Dict[Tuple[int, int], np.ndarray]:
    """Key-index match lists implied by adjusted points with >= threshold
    views (`SetMatchesFromPoints`, `src/MatchTracks.cpp:282-324`); emits
    both (i,j) and (j,i) directions like the reference's double loop."""
    lists: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for views in point_views:
        if len(views) < threshold:
            continue
        for (v1, k1) in views:
            for (v2, k2) in views:
                if v1 == v2:
                    continue
                lists.setdefault((v1, v2), []).append((k1, k2))
    return {ij: np.array(m, dtype=np.int32).reshape(-1, 2)
            for ij, m in lists.items()}


def write_track_file(path: str, num_images: int,
                     tracks: Sequence[Sequence[Tuple[int, int]]]) -> None:
    """`WriteTracks` (`src/BaseGeometry.cpp:364-393`): header
    `num_images num_tracks`, then per track `num_views img key img key ...`."""
    with open(path, "w") as f:
        f.write(f"{num_images} {len(tracks)}\n")
        for views in tracks:
            f.write(f"{len(views)} ")
            f.write(" ".join(f"{int(i)} {int(k)}" for i, k in views))
            f.write(" \n")


def read_track_file(path: str) -> Tuple[int, List[Track]]:
    with open(path) as f:
        n_img, n_tracks = map(int, f.readline().split())
        tracks: List[Track] = []
        for _ in range(n_tracks):
            toks = f.readline().split()
            nv = int(toks[0])
            tracks.append([(int(toks[1 + 2 * i]), int(toks[2 + 2 * i]))
                           for i in range(nv)])
    return n_img, tracks
