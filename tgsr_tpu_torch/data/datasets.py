"""Dataset adapters of the eval, calibration and training CLIs (counterpart
of tgsr_tpu/data/datasets.py): file discovery, caption indexing and the
decode + crop + resize of each image on the host, producing (hr uint8,
tokens, length, class id, key) examples.

Ported: `Example`, the shared caption base, `TextDataset` and `TextSRDataset`
(bird layout, the train vocabulary the example sets of bird, flower and coco
are encoded with), `TextFlowerDataset` (Oxford-102: text_c10/class_*/
caption files, the last 3 files of a class the test split), `TextCocoDataset`
(train2014 / val2014 images), `TextFaceDataset` (CelebA attribute captions,
and the sentence-caption variant), `TextExampleSRDataset` (the filename-list
+ caption-pickle eval set), `TextSRGTDataset` (generated SR images and their
captions, which `cli/eval_rank.py` ranks), `prepare_batch` and
`load_arbitrary_eval_image`. Images are PNG or JPEG, read by data/codec.py;
the deterministic eval crop goes through the host loader (native/, C), the
training crop through codec's PIL-exact filters in numpy. Both equal the
JAX package's PIL path bit for bit. (The JAX package prefers its own native
loader for the eval crop when that library is built, within 1/255 of PIL.)
"""

from __future__ import annotations

import os
import pickle
import re
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from tgsr_tpu_torch.data.codec import load_image_rgb, resize_pil
from tgsr_tpu_torch.data.tokenizer import (Vocab, build_dictionary, encode_caption,
                                           tokenize_caption)


def _load_and_resize(path: str, size: int, enlarge: float, rng=None) -> np.ndarray:
    """Decode + antialiased resize of the short side to size * enlarge, then
    a centre crop of size, or with `rng` (train augmentation) a random crop
    and a coin-flip mirror: Resize(int(imsize * enlarge)) + RandomCrop(imsize)
    + RandomHorizontalFlip. The centre crop runs in the host loader
    (`native.load_image`, equal to `_center_crop_resize` bit for bit)."""
    if rng is not None:
        return _random_crop_flip(load_image_rgb(path), size, enlarge, rng)
    from tgsr_tpu_torch import native

    return native.load_image(path, size, enlarge)


def _resize_short_side(img: np.ndarray, target: int) -> np.ndarray:
    """torchvision Resize(int) semantics through PIL's bilinear filter: short
    side -> target, long side int(target * long / short) (truncated)."""
    h, w = img.shape[:2]
    if w <= h:
        ow, oh = target, max(target, int(target * h / w))
    else:
        ow, oh = max(target, int(target * w / h)), target
    return resize_pil(img, (oh, ow), "bilinear")


def _random_crop_flip(img: np.ndarray, size: int, enlarge: float, rng) -> np.ndarray:
    """RandomCrop(size) + RandomHorizontalFlip over the short-side-resized
    image (the reference's training transform)."""
    resized = _resize_short_side(img, max(int(size * enlarge), size))
    h, w = resized.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    crop = resized[top:top + size, left:left + size]
    if rng.random() < 0.5:
        crop = crop[:, ::-1]
    return np.ascontiguousarray(crop)


def _center_crop_resize(img: np.ndarray, size: int, enlarge: float = 1.0) -> np.ndarray:
    """Resize the shorter side to size * enlarge, then centre-crop size
    (transforms.Resize(int(imsize * 72 / 64)) + CenterCrop(imsize))."""
    resized = _resize_short_side(img, max(int(size * enlarge), size))
    h, w = resized.shape[:2]
    left = (w - size) // 2
    top = (h - size) // 2
    return np.ascontiguousarray(resized[top:top + size, left:left + size])


def bbox_crop(img: np.ndarray, bbox: Sequence[int]) -> np.ndarray:
    """CUB bounding-box crop: the 0.75-padded square around the box."""
    h, w = img.shape[:2]
    r = int(np.maximum(bbox[2], bbox[3]) * 0.75)
    cx = int((2 * bbox[0] + bbox[2]) / 2)
    cy = int((2 * bbox[1] + bbox[3]) / 2)
    y1, y2 = max(0, cy - r), min(h, cy + r)
    x1, x2 = max(0, cx - r), min(w, cx + r)
    return img[y1:y2, x1:x2]


@dataclass
class Example:
    hr: np.ndarray  # [H, W, 3] uint8 (full resolution, before the pyramid)
    tokens: np.ndarray  # [T] int
    length: int
    class_id: int
    key: str


class _CaptionDatasetBase:
    """Shared caption and vocabulary machinery."""

    filenames: List[str]
    captions: List[List[int]]  # encoded; embeddings_num per image
    vocab: Vocab
    class_id: np.ndarray
    embeddings_num: int = 1
    words_num: int = 18
    imsize: int = 256
    # train-split adapters set this: the reference training transform is
    # Resize + RandomCrop + RandomHorizontalFlip; eval stays a centre crop
    augment: bool = False

    def __len__(self) -> int:
        return len(self.filenames)

    @property
    def n_words(self) -> int:
        return self.vocab.n_words

    def get_caption(self, sent_ix: int, rng: Optional[np.random.Generator] = None):
        return encode_caption(self.captions[sent_ix], self.words_num, rng)

    def _image(self, index: int, rng=None) -> np.ndarray:
        raise NotImplementedError

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None,
                    sent_ix: Optional[int] = None) -> Example:
        rng = rng or np.random.default_rng()
        if sent_ix is None:
            # a random caption per epoch; the test protocols pass caption 0
            sent_ix = int(rng.integers(0, self.embeddings_num))
        toks, length = self.get_caption(index * self.embeddings_num + sent_ix, rng)
        return Example(
            # augmentation draws ride the caller's rng, so that a (seed,
            # epoch)-deterministic loader stays deterministic
            hr=self._image(index, rng if self.augment else None),
            tokens=toks.astype(np.int32),
            length=length,
            class_id=int(self.class_id[index]),
            key=self.filenames[index],
        )


class TextDataset(_CaptionDatasetBase):
    """AttnGAN-style dataset (bird, coco): per-image caption .txt files, the
    vocabulary cached in captions.pickle."""

    def __init__(self, data_dir: str, split: str = "train", words_num: int = 18,
                 embeddings_num: int = 10, imsize: int = 256, no_stopwords: bool = False,
                 only_color: bool = False, cache_name: str = "captions.pickle"):
        self.data_dir = data_dir
        self.split = split
        self.augment = split == "train"
        self.words_num = words_num
        self.embeddings_num = embeddings_num
        self.imsize = imsize
        self.no_stopwords = no_stopwords
        self.only_color = only_color
        self.bbox = self._load_bbox() if data_dir.find("birds") != -1 else None

        train_names = self._load_filenames(data_dir, "train")
        test_names = self._load_filenames(data_dir, "test")
        cache = os.path.join(data_dir, cache_name)
        if os.path.isfile(cache):
            with open(cache, "rb") as f:
                x = pickle.load(f)
            train_caps, test_caps = x[0], x[1]
            self.vocab = Vocab(x[2], x[3])
        else:
            train_tok = self._load_captions(data_dir, train_names)
            test_tok = self._load_captions(data_dir, test_names)
            train_caps, test_caps, self.vocab = build_dictionary(train_tok, test_tok)
            with open(cache, "wb") as f:
                pickle.dump([train_caps, test_caps, self.vocab.ixtoword,
                             self.vocab.wordtoix], f, protocol=2)
        if split == "train":
            self.filenames, self.captions = train_names, train_caps
        else:
            self.filenames, self.captions = test_names, test_caps
        self.class_id = self._load_class_id(os.path.join(data_dir, split), len(self.filenames))

    def _load_bbox(self) -> Dict[str, List[int]]:
        boxes, names = [], []
        with open(os.path.join(self.data_dir, "CUB_200_2011/bounding_boxes.txt")) as f:
            for line in f:
                boxes.append([int(float(v)) for v in line.split()[1:5]])
        with open(os.path.join(self.data_dir, "CUB_200_2011/images.txt")) as f:
            for line in f:
                names.append(line.split()[1])
        return {n[:-4]: b for n, b in zip(names, boxes)}

    def _load_captions(self, data_dir, filenames):
        all_caps = []
        for name in filenames:
            with open(f"{data_dir}/text/{name}.txt", "rb") as f:
                caps = f.read().decode("utf8").split("\n")
            cnt = 0
            for cap in caps:
                if len(cap) == 0:
                    continue
                tokens = tokenize_caption(cap, self.no_stopwords, self.only_color)
                if not tokens:
                    continue
                all_caps.append(tokens)
                cnt += 1
                if cnt == self.embeddings_num:
                    break
            if cnt < self.embeddings_num:
                # the flat index * embeddings_num addressing is misaligned
                # for every later image: say so at the cause (the
                # reference's diagnostic, its %-count quirk included)
                print("ERROR: the captions for %s less than %d" % (name, cnt))
        return all_caps

    @staticmethod
    def _load_filenames(data_dir, split):
        path = f"{data_dir}/{split}/filenames.pickle"
        if os.path.isfile(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        return []

    @staticmethod
    def _load_class_id(split_dir, total):
        path = os.path.join(split_dir, "class_info.pickle")
        if os.path.isfile(path):
            with open(path, "rb") as f:
                return np.asarray(pickle.load(f, encoding="iso-8859-1"))
        return np.arange(total)

    def _image(self, index, rng=None):
        key = self.filenames[index]
        if self.bbox is not None:
            img = load_image_rgb(f"{self.data_dir}/CUB_200_2011/images/{key}.jpg")
            img = bbox_crop(img, self.bbox[key])
        else:
            img = load_image_rgb(f"{self.data_dir}/images/{key}.jpg")
        if rng is not None:
            return _random_crop_flip(img, self.imsize, 76 / 64, rng)
        from tgsr_tpu_torch import native

        return native.crop_resize(img, self.imsize, enlarge=76 / 64)


class TextFaceDataset(_CaptionDatasetBase):
    """CelebA attribute-caption dataset: captions are the names of the
    attributes set to 1 in list_attr_celeba.txt; the train / test split is
    attribute 11 (Blurry) == 0 / 1."""

    embeddings_num = 1

    def __init__(self, data_dir: str, data_dirim: Optional[str] = None, split: str = "train",
                 words_num: int = 18, imsize: int = 256,
                 cache_name: str = "captions_face.pickle"):
        self.data_dir = data_dir
        self.data_dirim = data_dirim or data_dir
        self.split = split
        self.augment = split == "train"
        self.words_num = words_num
        self.imsize = imsize

        cache = os.path.join(data_dir, cache_name)
        if os.path.isfile(cache):
            with open(cache, "rb") as f:
                train_caps, test_caps, ix2w, w2ix, train_names, test_names = pickle.load(f)
            self.vocab = Vocab(ix2w, w2ix)
        else:
            train_tok, train_names = self.load_attr_captions(data_dir, True)
            test_tok, test_names = self.load_attr_captions(data_dir, False)
            train_caps, test_caps, self.vocab = build_dictionary(train_tok, test_tok)
            with open(cache, "wb") as f:
                pickle.dump([train_caps, test_caps, self.vocab.ixtoword, self.vocab.wordtoix,
                             train_names, test_names], f, protocol=2)
        if split == "train":
            self.filenames, self.captions = train_names, train_caps
        else:
            self.filenames, self.captions = test_names, test_caps
        self.class_id = np.arange(len(self.filenames))

    @staticmethod
    def load_sentence_captions(data_dir: str, train: bool = True, caps_per_image: int = 5):
        """The sentence-caption variant: caps.txt lines are '<7-char
        id>...\\t<sent1>|<sent2>|...'; 5 captions an image (cycled when
        fewer); the 'test' split is the first 5 images. The reference's
        quirks kept: exactly one trailing character chopped per sentence,
        ''-words from double spaces kept (they enter the vocabulary), the
        cycled copies not chopped again."""
        all_caps, names = [], []
        with open(os.path.join(data_dir, "caps.txt")) as f:
            for line in f:
                sents = line[line.find("\t") + 1:-1].split("|")
                names.append(line[:7] + "png")
                for i in range(caps_per_image):
                    if len(sents) > i:
                        sents[i] = sents[i][:-1].replace(",", "").lower()
                        words = sents[i].split(" ")
                    else:
                        words = sents[i % len(sents)].split(" ")
                    all_caps.append(words)
        if not train:
            all_caps = all_caps[: 5 * caps_per_image]
            names = names[:5]
        return all_caps, names

    @staticmethod
    def load_attr_captions(data_dir: str, train: bool):
        """list_attr_celeba.txt: a header line of attribute names; an image's
        tokens are the names of its attributes set to '1'. Train keeps only
        rows with attr[11] == '0', test only '1'; rows with any other value
        (the -1 of stock CelebA files) are in neither split, as in the
        reference."""
        all_caps, names = [], []
        with open(os.path.join(data_dir, "list_attr_celeba.txt")) as f:
            lines = f.readlines()
        attr_list = lines[0].split(" ")[:-1]
        want = "1" if not train else "0"
        for line in lines[1:]:
            attr = line.split(" ")
            if len(attr) < 2:
                continue
            if attr[11] != want:
                continue
            names.append(attr[0][:-3] + "png")
            all_caps.append([attr_list[i - 1] for i in range(1, len(attr))
                             if attr[i] in ("1", "1\n")])
        return all_caps, names

    def _image(self, index, rng=None):
        # train augmentation uses the reference training transform's 76/64 enlarge; the
        # deterministic eval path keeps the example-test 72/64 centre crop
        return _load_and_resize(os.path.join(self.data_dirim, "Img", self.filenames[index]),
                                self.imsize, enlarge=76 / 64 if rng is not None else 72 / 64,
                                rng=rng)


class TextFlowerDataset(_CaptionDatasetBase):
    """Oxford-102: per-class text_c10/class_*/ caption files, the last 3
    files of each class the test split; images jpg/<name>.jpg."""

    def __init__(self, data_dir: str, split: str = "train", words_num: int = 18,
                 imsize: int = 256, embeddings_num: int = 10,
                 cache_name: str = "captions_flower_v2.pickle"):
        # cache v2: a '{}' first line duplicates the previous file's caption
        # (not dropped), so caches of the older scan carry misaligned flat
        # caption addressing; the new name forces a rescan
        self.data_dir = data_dir
        self.split = split
        self.augment = split == "train"
        self.words_num = words_num
        self.imsize = imsize
        self.embeddings_num = embeddings_num
        cache = os.path.join(data_dir, cache_name)
        if os.path.isfile(cache):
            with open(cache, "rb") as f:
                (train_caps, test_caps, ix2w, w2ix, train_names, test_names, train_cls,
                 test_cls) = pickle.load(f)
            self.vocab = Vocab(ix2w, w2ix)
        else:
            (train_tok, train_names, train_cls, test_tok, test_names,
             test_cls) = self._scan(data_dir)
            train_caps, test_caps, self.vocab = build_dictionary(train_tok, test_tok)
            with open(cache, "wb") as f:
                pickle.dump([train_caps, test_caps, self.vocab.ixtoword, self.vocab.wordtoix,
                             train_names, test_names, train_cls, test_cls], f, protocol=2)
        if split == "train":
            self.filenames, self.captions = train_names, train_caps
            self.class_id = np.asarray(train_cls)
        else:
            # the reference eval protocol: one image per class triple
            # (filenames[::3]) with one deterministic caption per kept image
            # (flat captions[::embeddings_num * 3], caption index = image
            # index): embeddings_num 1 reproduces that addressing
            self.filenames = test_names[::3]
            self.captions = test_caps[::self.embeddings_num * 3]
            self.class_id = np.asarray(test_cls[::3])
            self.embeddings_num = 1

    def _scan(self, data_dir):
        train_tok, train_names, train_cls = [], [], []
        test_tok, test_names, test_cls = [], [], []
        last_cap = None  # one flat list: '{}' opening a file repeats the previous file's last caption
        root = os.path.join(data_dir, "text_c10")
        for cls_dir in sorted(os.listdir(root)):
            m = re.match(r"class_(\d+)", cls_dir)
            if not m:
                continue
            cls = int(m.group(1))
            files = sorted(f for f in os.listdir(os.path.join(root, cls_dir)) if f.endswith(".txt"))
            for i, fn in enumerate(files):
                is_test = i >= len(files) - 3  # the last 3 of a class are the test split
                with open(os.path.join(root, cls_dir, fn), "rb") as f:
                    caps = f.read().decode("utf8").split("\n")
                toks = []
                for cap in caps:
                    if cap == "{}":
                        # the reference's placeholder line repeats the previous
                        # caption, so every file still yields embeddings_num
                        # captions and the flat addressing stays aligned
                        prev = toks[-1] if toks else last_cap
                        if prev is not None:
                            toks.append(prev)
                    elif cap:
                        t = tokenize_caption(cap)
                        if t:
                            toks.append(t)
                    if toks:
                        last_cap = toks[-1]
                    if len(toks) == self.embeddings_num:
                        break
                name = fn[:-4]
                if is_test:
                    test_tok.extend(toks)
                    test_names.append(name)
                    test_cls.append(cls)
                else:
                    train_tok.extend(toks)
                    train_names.append(name)
                    train_cls.append(cls)
        return train_tok, train_names, train_cls, test_tok, test_names, test_cls

    def _image(self, index, rng=None):
        return _load_and_resize(f"{self.data_dir}/jpg/{self.filenames[index]}.jpg",
                                self.imsize, enlarge=76 / 64, rng=rng)


class TextExampleSRDataset(_CaptionDatasetBase):
    """The eval set driven by a filename list and a prebuilt caption pickle
    ([captions, ixtoword, wordtoix]; testset.pickle of the face x8 eval)."""

    embeddings_num = 1

    def __init__(self, data_dir: str, caption_pickle: str,
                 image_subdir: str = "Img/changetxt_im1",
                 filenames: Optional[List[str]] = None, words_num: int = 18,
                 imsize: int = 256, meaningless: bool = False):
        self.data_dir = data_dir
        self.image_subdir = image_subdir
        self.words_num = words_num
        self.imsize = imsize
        with open(caption_pickle, "rb") as f:
            caps, ix2w, w2ix = pickle.load(f)
        self.vocab = Vocab(ix2w, w2ix)
        if meaningless:
            # control experiment: a constant token-1 caption
            caps = [[1] for _ in caps]
        self.captions = caps
        if filenames is None:
            img_dir = os.path.join(data_dir, image_subdir)
            attr_txt = os.path.join(data_dir, "testset.txt")
            if os.path.isdir(img_dir):
                filenames = sorted(os.listdir(img_dir))[: len(caps)]
            elif os.path.isfile(attr_txt):
                # image names from the attribute table in caption order:
                # train rows first, then test rows, as the caption pickle
                with open(attr_txt) as f:
                    lines = f.readlines()[1:]
                tr, te = [], []
                for line in lines:
                    attr = line.split(" ")
                    if len(attr) < 2:
                        continue
                    (te if attr[11] == "1" else tr).append(attr[0][:-3] + "png")
                filenames = (tr + te)[: len(caps)]
            else:
                filenames = [f"{i:06d}.png" for i in range(len(caps))]
            # partial snapshots: keep only the caption / file pairs whose
            # image exists, so that the eval runs on whatever is present
            present = [i for i, fn in enumerate(filenames)
                       if os.path.exists(os.path.join(data_dir, image_subdir, fn))
                       or os.path.exists(os.path.join(data_dir, fn))]
            if present and len(present) < len(filenames):
                warnings.warn(
                    f"TextExampleSRDataset: {len(filenames) - len(present)}"
                    f"/{len(filenames)} listed images missing under "
                    f"{data_dir}; evaluating the {len(present)} present")
                filenames = [filenames[i] for i in present]
                self.captions = [self.captions[i] for i in present if i < len(self.captions)]
        self.filenames = filenames
        self.class_id = np.arange(len(self.filenames))

    def _image(self, index, rng=None):
        path = os.path.join(self.data_dir, self.image_subdir, self.filenames[index])
        if not os.path.exists(path):
            path = os.path.join(self.data_dir, self.filenames[index])
        return _load_and_resize(path, self.imsize, enlarge=72 / 64)


class TextSRDataset(TextDataset):
    """The SR training dataset: TextDataset with the captions5450.pickle
    cache, the stopword-filtered and colour-word-only caption variants, and
    the test split pinned to caption 0."""

    def __init__(self, data_dir: str, split: str = "train", words_num: int = 18,
                 embeddings_num: int = 10, imsize: int = 256, no_stopwords: bool = False,
                 only_color: bool = False):
        cache = "captions5450.pickle"
        if no_stopwords:
            cache = "captions5450_nostop.pickle"
        if only_color:
            cache = "captions5450_color.pickle"
        super().__init__(data_dir, split, words_num, embeddings_num, imsize, no_stopwords,
                         only_color, cache_name=cache)

    def __getitem__(self, index, rng=None, sent_ix=None):
        if self.split != "train" and sent_ix is None:
            sent_ix = 0  # the deterministic test caption
        return super().__getitem__(index, rng, sent_ix)


class TextCocoDataset(TextDataset):
    """COCO: the TextDataset layout with images/train2014 and
    images/val2014 JPEGs."""

    def _image(self, index, rng=None):
        key = self.filenames[index]
        sub = "train2014" if self.split == "train" else "val2014"
        return _load_and_resize(f"{self.data_dir}/images/{sub}/{key}.jpg", self.imsize,
                                enlarge=76 / 64, rng=rng)


class TextSRGTDataset(_CaptionDatasetBase):
    """Generated SR images and their captions, for ranking (= datasets.py
    :1721-1885; tgsr_tpu/data/datasets.py:614-677). Two caption formats in
    `txt`: face, the attribute table (a header of attribute names, then
    'name|<flags>' lines whose 1s name the caption's words); other,
    'name|caption text' lines."""

    embeddings_num = 1

    def __init__(self, vocab: Vocab, data_dir: str, image_dir: str, txt: str = "testset.txt",
                 dataset: str = "bird", words_num: int = 18, imsize: int = 256):
        self.vocab = vocab
        self.data_dir = data_dir
        self.image_dir = image_dir
        self.words_num = words_num
        self.imsize = imsize
        self.filenames: List[str] = []
        raw_caps: List[List[str]] = []
        with open(os.path.join(data_dir, txt)) as f:
            lines = f.readlines()
        if dataset == "face":
            attr_list = lines[0].split(" ")[:-1]
            for line in lines[1:]:
                parts = line.split("|")
                if len(parts) < 2:
                    continue
                self.filenames.append(parts[0])
                attr = parts[1].split(" ")
                raw_caps.append([attr_list[i - 1] for i in range(1, len(attr))
                                 if attr[i] in ("1", "1\n")])
        else:
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                parts = line.split("|")
                self.filenames.append(parts[0])
                raw_caps.append(tokenize_caption(parts[1] if len(parts) > 1 else ""))
        self.captions = [vocab.encode_tokens(t) for t in raw_caps]
        self.class_id = np.arange(len(self.filenames))

    def _image(self, index, rng=None):
        """= transforms.CenterCrop(imsize), no resize (datasets.py:1726): a
        side below imsize is zero-padded around the image first, as
        torchvision's CenterCrop pads."""
        img = load_image_rgb(os.path.join(self.image_dir, self.filenames[index]))
        h, w = img.shape[:2]
        if h < self.imsize or w < self.imsize:
            canvas = np.zeros((max(h, self.imsize), max(w, self.imsize), 3), img.dtype)
            top, left = (canvas.shape[0] - h) // 2, (canvas.shape[1] - w) // 2
            canvas[top:top + h, left:left + w] = img
            img = canvas
            h, w = img.shape[:2]
        top, left = max(0, (h - self.imsize) // 2), max(0, (w - self.imsize) // 2)
        return img[top:top + self.imsize, left:left + self.imsize]


def prepare_batch(examples: Sequence[Example]) -> Dict[str, np.ndarray]:
    """Collate host examples into a numpy batch (no sort by length: the
    masked text encoder does not need it)."""
    return {
        "hr": np.stack([e.hr for e in examples]),
        "captions": np.stack([e.tokens for e in examples]),
        "cap_lens": np.asarray([e.length for e in examples], np.int32),
        "class_ids": np.asarray([e.class_id for e in examples], np.int32),
        "keys": [e.key for e in examples],
    }


def load_arbitrary_eval_image(path_or_img, scale: int):
    """Arbitrary-size eval image: crop H and W down to multiples of `scale`
    (anchored top-left), and the LR input by PIL's bilinear downscale.
    `path_or_img` is an image file or uint8 RGB [H, W, 3].

    Returns (lr [1, h / scale, w / scale, 3] float32 in [-1, 1],
             gt [H, W, 3] uint8, the cropped ground truth)."""
    img = (np.asarray(path_or_img) if isinstance(path_or_img, np.ndarray)
           else load_image_rgb(path_or_img))
    h, w = img.shape[:2]
    h2, w2 = (h // scale) * scale, (w // scale) * scale
    gt = np.ascontiguousarray(img[:h2, :w2])
    lr = resize_pil(gt, (h2 // scale, w2 // scale), "bilinear")
    return (lr.astype(np.float32) / 127.5 - 1.0)[None], gt
