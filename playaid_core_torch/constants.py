"""Filesystem layout, asset paths and sampling defaults.

The port's own copy of ``playaid_core_tpu/constants.py``; the game-data
paths point at this package's ``game_data/``, byte-identical copies of the
JAX package's files.  Rebuild of the reference constants module
(reference: constants.py:1-54) with two portability fixes the reference
needed:

* every root is overridable through environment variables so the framework
  runs anywhere (the reference hard-coded macOS font paths,
  constants.py:19-20);
* font resolution falls back through a candidate list instead of assuming
  a single absolute path.
"""

import os

REPO_ROOT = os.environ.get(
    "PLAYAID_ROOT", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
)
# Where big mutable datasets / caches live.  Defaults keep the reference's
# layout (reference: constants.py:3-23) but everything hangs off one
# overridable root.
DATA_ROOT = os.environ.get("PLAYAID_DATA_ROOT", REPO_ROOT)

EXPERIMENT_OUTPUT = os.path.join(DATA_ROOT, "experiment_output")
TRACKER_INFERENCE_DATASET_DIR = os.path.join(EXPERIMENT_OUTPUT, "tracker-inference-dataset")
YOLO_DIR = os.path.join(DATA_ROOT, "third_party", "yolov5")
ACTION_RECOG_OUTPUT_DIR = os.path.join(DATA_ROOT, "logs", "action_recog")
SAVED_MODELS = os.path.join(DATA_ROOT, "models")
SAVED_YOLO_MODELS = os.path.join(SAVED_MODELS, "yolo")
SAVED_ACTION_MODELS = os.path.join(SAVED_MODELS, "action")

PACKAGE_ROOT = os.path.dirname(os.path.abspath(__file__))
GAME_DATA_DIR = os.path.join(PACKAGE_ROOT, "game_data")
PARAMS_LABELS = os.path.join(GAME_DATA_DIR, "params_labels.csv")
ONTOLOGY_JSON = os.path.join(GAME_DATA_DIR, "ontology.json")
FIGHTERS_JSON = os.path.join(GAME_DATA_DIR, "fighters.json")
STAGES_JSON = os.path.join(GAME_DATA_DIR, "stages.json")
STATUS_KINDS_JSON = os.path.join(GAME_DATA_DIR, "status_kinds.json")
FIGHTER_STATUS_KINDS_JSON = os.path.join(GAME_DATA_DIR, "fighter_status_kinds.json")
FIGHTER_SPECIAL_NAMES_JSON = os.path.join(GAME_DATA_DIR, "fighter_special_names.json")
TRAINED_ACTIONS_JSON = os.path.join(GAME_DATA_DIR, "trained_actions.json")
FRAME_DATA_JSON_GZ = os.path.join(GAME_DATA_DIR, "frame_data.json.gz")

ULT_DATASET_DIR = os.path.realpath(os.path.join(DATA_ROOT, "ult_dataset"))
REPLAYS_DIR = os.path.realpath(os.path.join(ULT_DATASET_DIR, "replays"))
AI_CACHE = os.path.join(DATA_ROOT, "ai_cache")

GROUND_TRUTH_DIR = os.path.realpath(os.path.join(ULT_DATASET_DIR, "ground_truth"))
GROUND_TRUTH_TRAIN = os.path.join(GROUND_TRUTH_DIR, "train.csv")
GROUND_TRUTH_VAL = os.path.join(GROUND_TRUTH_DIR, "val.csv")
GROUND_TRUTH_TEST = os.path.join(GROUND_TRUTH_DIR, "test.csv")
GROUND_TRUTH_EXTRAS = os.path.join(GROUND_TRUTH_DIR, "extras.csv")

GROUND_TRUTH_CHAR_DETECTION_DIR = os.path.join(ULT_DATASET_DIR, "gt_char_detection")

ACTION_GROUND_TRUTH_DIR = os.path.realpath(os.path.join(ULT_DATASET_DIR, "gt_action_detection"))
ACTION_GROUND_TRUTH_TRAIN = os.path.join(ACTION_GROUND_TRUTH_DIR, "train")
ACTION_GROUND_TRUTH_VAL = os.path.join(ACTION_GROUND_TRUTH_DIR, "validation")
ACTION_GROUND_TRUTH_TEST = os.path.join(ACTION_GROUND_TRUTH_DIR, "test")

ULT_DATASET_RAW_CHAR_DIR = os.path.join(ULT_DATASET_DIR, "char_detect_data", "raw")
ULT_DATASET_CLEAN_CHAR_DIR = os.path.join(ULT_DATASET_DIR, "char_detect_data", "clean")
ULT_STAGES_DIR = os.path.join(ULT_DATASET_DIR, "ultimate_stages")
COMPOSITES_DIR = os.path.join(ULT_DATASET_DIR, "composites")

GROUND_TRUTH_VIDEO = os.path.join(ULT_DATASET_DIR, "ult_videos", "tweek-mkleo-clip.mp4")
GROUND_TRUTH_SAMPLE = os.path.join(DATA_ROOT, "playaid", "tweek-mkleo-clip-label.csv")

SYNTH_ACTION_RECOGNITON_DIR = os.path.join(ULT_DATASET_DIR, "synth_char_action_recognition")
SYNTH_ACTION_RECOGNITON_FRAMES_DIR = os.path.join(SYNTH_ACTION_RECOGNITON_DIR, "frames")
SYNTH_ACTION_RECOGNITON_ANNOTATIONS_DIR = os.path.join(
    SYNTH_ACTION_RECOGNITON_DIR, "annotations"
)

# The six characters the reference shipped trained detectors for
# (reference: constants.py:51).
CHAR_LIST = ["Byleth", "Diddy Kong", "Pikachu", "Joker", "Donkey Kong", "Jigglypuff"]

ACTION_RECOG_NUM_FRAMES_PER_SAMPLE = 4
ACTION_RECOG_FRAME_DELTA = 1


def _first_existing(paths, default):
    for p in paths:
        if os.path.exists(p):
            return p
    return default


TEXT_FONT_PATH = os.environ.get(
    "PLAYAID_TEXT_FONT",
    _first_existing(
        [
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
            "/usr/share/fonts/truetype/liberation/LiberationSans-Regular.ttf",
            "/usr/share/fonts/TTF/DejaVuSans.ttf",
            "/Library/Fonts/Arial.ttf",
        ],
        "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    ),
)
EMOJI_FONT_PATH = os.environ.get("PLAYAID_EMOJI_FONT", TEXT_FONT_PATH)
