"""Labelsets, visualization palettes, and the nuScenes synonym mapper.

Dataset-defined constants with the same content as the reference's
``dataset/label_constants.py`` (the label names and colors are fixed facts of
the ScanNet / Matterport / nuScenes benchmarks, not code).  Palettes are
exposed as flat ``np.ndarray`` RGB triplets exactly as ``util/util.py:205-241``
produces them.
"""

from __future__ import annotations

import numpy as np

UNKNOWN_ID = 255  # ignored ground-truth label (reference util/metric.py:5)
NO_FEATURE_ID = 256  # prediction sentinel for points with no fused feature

SCANNET_LABELS_20 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)

MATTERPORT_LABELS_21 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub", "other",
    "ceiling",
)

MATTERPORT_LABELS_40 = (
    "wall", "door", "ceiling", "floor", "picture", "window", "chair",
    "pillow", "lamp", "cabinet", "curtain", "table", "plant", "mirror",
    "towel", "sink", "shelves", "sofa", "bed", "night stand", "toilet",
    "column", "banister", "stairs", "stool", "vase", "television", "pot",
    "desk", "box", "coffee table", "counter", "bench", "garbage bin",
    "fireplace", "clothes", "bathtub", "book", "air vent", "faucet",
)

MATTERPORT_LABELS_80 = MATTERPORT_LABELS_40 + (
    "photo", "toilet paper", "fan", "railing", "sculpture", "dresser", "rug",
    "ottoman", "bottle", "refridgerator", "bookshelf", "wardrobe", "pipe",
    "monitor", "stand", "drawer", "container", "light switch", "purse",
    "door way", "basket", "chandelier", "oven", "clock", "stove",
    "washing machine", "shower curtain", "fire alarm", "bin", "chest",
    "microwave", "blinds", "bowl", "tissue box", "plate", "tv stand", "shoe",
    "heater", "headboard", "bucket",
)

MATTERPORT_LABELS_160 = MATTERPORT_LABELS_80 + (
    "candle", "flower pot", "speaker", "furniture", "sign",
    "air conditioner", "fire extinguisher", "curtain rod", "floor mat",
    "printer", "telephone", "blanket", "handle", "shower head", "soap",
    "keyboard", "thermostat", "radiator", "kitchen island", "paper towel",
    "sheet", "glass", "dishwasher", "cup", "ladder", "garage door", "hat",
    "exit sign", "piano", "board", "rope", "ball", "excercise equipment",
    "hanger", "candlestick", "light", "scale", "bag", "laptop", "treadmill",
    "guitar", "display case", "toilet paper holder", "bar", "tray", "urn",
    "decorative plate", "pool table", "jacket", "bottle of soap",
    "water cooler", "utensil", "tea pot", "stuffed animal",
    "paper towel dispenser", "lamp shade", "car", "toilet brush", "doll",
    "drum", "whiteboard", "range hood", "candelabra", "toy", "foot rest",
    "soap dish", "placemat", "cleaner", "computer", "knob", "paper",
    "projector", "coat hanger", "case", "pan", "luggage", "trinket",
    "chimney", "person", "alarm",
)

NUSCENES_LABELS_16 = (
    "barrier", "bicycle", "bus", "car", "construction vehicle", "motorcycle",
    "person", "traffic cone", "trailer", "truck", "drivable surface",
    "other flat", "sidewalk", "terrain", "manmade", "vegetation",
)

# Expanded synonym/subclass prompts for nuScenes open-vocabulary eval; argmax
# over these 43 prompts is mapped back to the 16 benchmark classes.
NUSCENES_LABELS_DETAILS = (
    "barrier", "barricade", "bicycle", "bus", "car", "bulldozer", "excavator",
    "concrete mixer", "crane", "dump truck", "motorcycle", "person",
    "pedestrian", "traffic cone", "trailer", "semi trailer",
    "cargo container", "shipping container", "freight container", "truck",
    "road", "curb", "traffic island", "traffic median", "sidewalk", "grass",
    "grassland", "lawn", "meadow", "turf", "sod", "building", "wall", "pole",
    "awning", "tree", "trunk", "tree trunk", "bush", "shrub", "plant",
    "flower", "woods",
)

MAPPING_NUSCENES_DETAILS = (
    0, 0, 1, 2, 3, 4, 4, 4, 4, 4,
    5, 6, 6, 7, 8, 8, 8, 8, 8,
    9, 10, 11, 11, 11, 12, 13, 13, 13, 13, 13, 13,
    14, 14, 14, 14, 15, 15, 15, 15, 15, 15, 15, 15,
)

# ---------------------------------------------------------------------------
# Visualization palettes.  Stored as ordered (r, g, b) rows; flattened to the
# reference's flat palette layout by get_palette().
# ---------------------------------------------------------------------------

_SCANNET_COLORS = [
    (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
    (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
    (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
    (247, 182, 210), (219, 219, 141), (255, 127, 14), (158, 218, 229),
    (44, 160, 44), (112, 128, 144), (227, 119, 194), (82, 84, 163),
    (0, 0, 0),  # unlabeled/unknown
]

# Matterport-21 shares ScanNet's colors for the 20 common classes, then adds
# ceiling before the unknown sentinel.
_MATTERPORT21_COLORS = _SCANNET_COLORS[:20] + [(58, 98, 26), (0, 0, 0)]

_NUSCENES16_COLORS = [
    (220, 220, 0), (119, 11, 32), (0, 60, 100), (0, 0, 250), (230, 230, 250),
    (0, 0, 230), (220, 20, 60), (250, 170, 30), (200, 150, 0), (0, 0, 110),
    (128, 64, 128), (0, 250, 250), (244, 35, 232), (152, 251, 152),
    (70, 70, 70), (107, 142, 35), (0, 0, 0),
]

_MATTERPORT160_COLORS = [
    (174, 199, 232), (214, 39, 40), (186, 197, 62), (152, 223, 138),
    (196, 156, 148), (197, 176, 213), (188, 189, 34), (141, 91, 229),
    (237, 204, 37), (31, 119, 180), (219, 219, 141), (255, 152, 150),
    (150, 53, 56), (162, 62, 60), (62, 143, 148), (112, 128, 144),
    (229, 91, 104), (140, 86, 75), (255, 187, 120), (137, 63, 14),
    (44, 160, 44), (39, 19, 208), (64, 158, 70), (208, 49, 84),
    (90, 119, 201), (118, 174, 76), (143, 45, 115), (153, 108, 234),
    (247, 182, 210), (177, 82, 239), (58, 98, 137), (23, 190, 207),
    (17, 242, 171), (79, 55, 137), (127, 63, 52), (34, 14, 130),
    (227, 119, 194), (192, 229, 91), (49, 206, 87), (250, 253, 26),
    (0, 0, 0),
    (82, 75, 227), (253, 59, 222), (240, 130, 89), (123, 172, 47),
    (71, 194, 133), (24, 94, 205), (134, 16, 179), (159, 32, 52),
    (213, 208, 88), (64, 158, 70), (18, 163, 194), (65, 29, 153),
    (177, 10, 109), (152, 83, 7), (83, 175, 30), (18, 199, 153),
    (61, 81, 208), (213, 85, 216), (170, 53, 42), (161, 192, 38),
    (23, 241, 91), (12, 103, 170), (151, 41, 245), (133, 51, 80),
    (184, 162, 91), (50, 138, 38), (31, 237, 236), (39, 19, 208),
    (223, 27, 180), (254, 141, 85), (97, 144, 39), (106, 231, 176),
    (12, 61, 162), (124, 66, 140), (137, 66, 73), (250, 253, 26),
    (55, 191, 73), (60, 126, 146), (153, 108, 234), (184, 58, 125),
    (135, 84, 14), (139, 248, 91), (53, 200, 172), (63, 69, 134),
    (190, 75, 186), (127, 63, 52), (141, 182, 25), (56, 144, 89),
    (64, 160, 250), (182, 86, 245), (139, 18, 53), (134, 120, 54),
    (49, 165, 42), (51, 128, 133), (44, 21, 163), (232, 93, 193),
    (176, 102, 54), (116, 217, 17), (54, 209, 150), (60, 99, 204),
    (129, 43, 144), (252, 100, 106), (187, 196, 73), (13, 158, 40),
    (52, 122, 152), (128, 76, 202), (187, 50, 115), (180, 141, 71),
    (77, 208, 35), (72, 183, 168), (97, 99, 203), (172, 22, 158),
    (155, 64, 40), (118, 159, 30), (69, 252, 148), (45, 103, 173),
    (111, 38, 149), (184, 9, 49), (188, 174, 67), (53, 206, 53),
    (97, 235, 252), (66, 32, 182), (236, 114, 195), (241, 154, 83),
    (133, 240, 52), (16, 205, 144), (75, 101, 198), (237, 95, 251),
    (191, 52, 49), (227, 254, 54), (49, 206, 87), (48, 113, 150),
    (125, 73, 182), (229, 32, 114), (158, 119, 28), (60, 205, 27),
    (18, 215, 201), (79, 76, 153), (134, 13, 116), (192, 97, 63),
    (108, 163, 18), (95, 220, 156), (98, 141, 208), (144, 19, 193),
    (166, 36, 57), (212, 202, 34), (23, 206, 34), (91, 211, 236),
    (79, 55, 137), (182, 19, 117), (134, 76, 14), (87, 185, 28),
    (82, 224, 187), (92, 110, 214), (168, 80, 171), (197, 63, 51),
    (175, 199, 77), (62, 180, 98), (8, 91, 150), (77, 15, 130),
    (154, 65, 96), (197, 152, 11), (59, 155, 45), (12, 147, 145),
    (54, 35, 219), (210, 73, 181), (221, 124, 77), (149, 214, 66),
    (72, 185, 134), (42, 94, 198), (0, 0, 0),
]


def get_palette(num_cls: int = 21, colormap: str = "scannet") -> np.ndarray:
    """Flat [r0,g0,b0,r1,g1,b1,...] palette (reference util/util.py:205-241)."""
    table = {
        "scannet": _SCANNET_COLORS,
        "matterport": _MATTERPORT21_COLORS,
        "matterport_160": _MATTERPORT160_COLORS,
        "nuscenes16": _NUSCENES16_COLORS,
    }.get(colormap)
    if table is not None:
        return np.asarray(table, dtype=np.float64).reshape(-1)
    # fallback: the VOC-style bit-twiddled palette
    palette = np.zeros(num_cls * 3, dtype=np.int64)
    for j in range(num_cls):
        lab, i = j, 0
        while lab > 0:
            palette[j * 3 + 0] |= ((lab >> 0) & 1) << (7 - i)
            palette[j * 3 + 1] |= ((lab >> 1) & 1) << (7 - i)
            palette[j * 3 + 2] |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
    return palette.astype(np.float64)


def labelset_and_palette(labelset_name: str,
                         map_nuscenes_details: bool = False):
    """Resolve (labelset list, palette, mapper) from a labelset/dataset name.

    Mirrors ``run/evaluate.py:67-101``: the trailing 'unlabeled' entry is
    appended by the caller after text-feature extraction; here we return the
    class labels only.  ``mapper`` is the detail->class id map (np.ndarray) for
    nuScenes, else None.
    """
    name = labelset_name
    if "scannet" in name:
        labels = list(SCANNET_LABELS_20)
        labels[-1] = "other"  # 'otherfurniture' -> 'other' for text prompting
        palette = get_palette(colormap="scannet")
    elif name in ("matterport_3d", "matterport"):
        labels = list(MATTERPORT_LABELS_21)
        palette = get_palette(colormap="matterport")
    elif "matterport_3d_40" in name or name == "matterport40":
        labels = list(MATTERPORT_LABELS_40)
        palette = get_palette(colormap="matterport_160")
    elif "matterport_3d_80" in name or name == "matterport80":
        labels = list(MATTERPORT_LABELS_80)
        palette = get_palette(colormap="matterport_160")
    elif "matterport_3d_160" in name or name == "matterport160":
        labels = list(MATTERPORT_LABELS_160)
        palette = get_palette(colormap="matterport_160")
    elif "nuscenes" in name:
        labels = list(NUSCENES_LABELS_16)
        palette = get_palette(colormap="nuscenes16")
    else:  # arbitrary dataset: use the largest labelset
        labels = list(MATTERPORT_LABELS_160)
        palette = get_palette(colormap="matterport_160")

    mapper = None
    if map_nuscenes_details:
        labels = list(NUSCENES_LABELS_DETAILS)
        mapper = np.asarray(MAPPING_NUSCENES_DETAILS, dtype=np.int64)
    return labels, palette, mapper


def labels_for_dataset(dataset: str):
    """Class labels used by the confusion-matrix metric
    (reference util/metric.py:47-60)."""
    if "scannet_3d" in dataset:
        return SCANNET_LABELS_20
    if "matterport_3d_40" in dataset:
        return MATTERPORT_LABELS_40
    if "matterport_3d_80" in dataset:
        return MATTERPORT_LABELS_80
    if "matterport_3d_160" in dataset:
        return MATTERPORT_LABELS_160
    if "matterport_3d" in dataset:
        return MATTERPORT_LABELS_21
    if "nuscenes_3d" in dataset:
        return NUSCENES_LABELS_16
    raise NotImplementedError(dataset)


def convert_labels_with_palette(label_ids: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Per-point RGB in [0,1] from label ids (reference util/util.py:243-259);
    id 255 renders with palette slot 20."""
    ids = np.where(label_ids == 255, 20, label_ids).astype(np.int64)
    pal = palette.reshape(-1, 3) / 255.0
    return pal[ids]
