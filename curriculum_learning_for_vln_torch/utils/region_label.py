"""Matterport region-type labels (ref: tasks/R2R-judy/src/utils/
region_label.py:1-33; not on the main training path).  The port of
``curriculum_learning_for_vln_tpu/utils/region_label.py``, data and
loader as they are.

The single-letter codes come from the Matterport3D house-segmentation
annotation format; descriptions follow the official dataset docs.
"""

REGION_LABELS = {
    "a": "bathroom (should have a toilet and a sink)",
    "b": "bedroom",
    "c": "closet",
    "d": "dining room (includes breakfast rooms and other rooms people mainly eat in)",
    "e": "entryway/foyer/lobby (should be the front door, not any door)",
    "f": "familyroom (a room a family hangs out in, not any area with couches)",
    "g": "garage",
    "h": "hallway",
    "i": "library (like a university library, not an individual study)",
    "j": "laundryroom/mudroom (place where people do laundry, etc.)",
    "k": "kitchen",
    "l": "living room (the main showcase living room, not any area with couches)",
    "m": "meetingroom/conferenceroom",
    "n": "lounge (relaxing area with comfy chairs/couches that is not family/living room)",
    "o": "office (usually for an individual, or a small set of people)",
    "p": "porch/terrace/deck/driveway (must be outdoors on ground level)",
    "r": "rec/game (should have recreational objects, like pool table, etc.)",
    "s": "stairs",
    "t": "toilet (a small room with ONLY a toilet)",
    "u": "utilityroom/toolroom",
    "v": "tv (must have theater-style seating)",
    "w": "workout/gym/exercise",
    "x": "outdoor areas containing grass, plants, bushes, trees, etc.",
    "y": "balcony (must be outside and must not be on ground floor)",
    "z": "other room (clearly a room, but the function is not clear)",
    "B": "bar",
    "C": "classroom",
    "D": "dining booth",
    "S": "spa/sauna",
    "Z": "junk (mirror reflections, random points floating in space, etc.)",
    "-": "no label",
}


def load_room_connectivity(scans, room_connectivity_dir: str = "room_connectivity"):
    """Room-level connectivity: room name -> viewpoint ids per scan
    (ref: misc.py:72-87; unused on the main path)."""
    import os
    from collections import defaultdict

    connectivity = {}
    for scan in scans:
        path = os.path.join(room_connectivity_dir, f"{scan}_panorama_to_region.txt")
        with open(path) as f:
            lines = [line.strip().split() for line in f.readlines()]
        room_info = defaultdict(list)
        for _, viewpoint_id, room_idx, room_type in lines:
            room_info[f"{room_idx}_{room_type}"].append(viewpoint_id)
        connectivity[scan] = dict(room_info)
    return connectivity
