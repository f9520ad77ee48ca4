"""Synthetic E2E-NLG-style corpus (restaurant-domain table-to-text).

The paper fine-tunes on the E2E dataset [Novikova et al. 2017]: meaning
representations like ``name[The Eagle], food[French], priceRange[cheap]``
paired with a natural-language reference.  No network access exists in this
container, so we generate a corpus with the same task shape: 8 slots, the
official value inventories, and templated-but-varied references.  Sizes
match the paper (~42k train / 4.6k val / 4.6k test).

The port's own copy of ``repro.data.e2e``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

NAMES = ["The Eagle", "The Mill", "Loch Fyne", "Bibimbap House", "The Vaults",
         "Clowns", "The Cricketers", "Green Man", "Zizzi", "Strada",
         "The Phoenix", "Cotto", "The Punter", "Aromi", "Blue Spice"]
FOODS = ["French", "Italian", "Japanese", "Indian", "Chinese", "English", "Fast food"]
PRICES = ["cheap", "moderate", "high", "less than £20", "£20-25", "more than £30"]
RATINGS = ["1 out of 5", "3 out of 5", "5 out of 5", "low", "average", "high"]
AREAS = ["city centre", "riverside"]
FAMILY = ["yes", "no"]
NEARS = ["Burger King", "Café Rouge", "The Bakers", "Raja Indian Cuisine",
         "Express by Holiday Inn", "The Six Bells", "Crowne Plaza Hotel"]
EATTYPES = ["restaurant", "pub", "coffee shop"]

_TEMPLATES = [
    "{name} is a {price} {food} {eattype} in the {area} near {near} . "
    "it has a {rating} customer rating .",
    "near {near} in the {area} , {name} serves {food} food at {price} prices "
    "with a {rating} rating .",
    "{name} , a {eattype} serving {food} food , is located in the {area} . "
    "it is {price} and rated {rating} .",
    "for {food} food at {price} prices try {name} , a {eattype} near {near} .",
    "{name} is a {family_txt} {eattype} with {food} food , {price} prices , "
    "and a {rating} customer rating , in the {area} .",
]


@dataclass(frozen=True)
class Example:
    mr: str         # meaning representation (input)
    ref: str        # reference text (target)

    @property
    def text(self) -> str:
        return f"{self.mr} <sep> {self.ref}"


def _one(rng: random.Random) -> Example:
    slots: Dict[str, str] = {
        "name": rng.choice(NAMES),
        "food": rng.choice(FOODS),
        "price": rng.choice(PRICES),
        "rating": rng.choice(RATINGS),
        "area": rng.choice(AREAS),
        "family": rng.choice(FAMILY),
        "near": rng.choice(NEARS),
        "eattype": rng.choice(EATTYPES),
    }
    mr_parts = [f"name[{slots['name']}]", f"food[{slots['food']}]",
                f"priceRange[{slots['price']}]"]
    if rng.random() < 0.7:
        mr_parts.append(f"customer rating[{slots['rating']}]")
    if rng.random() < 0.6:
        mr_parts.append(f"area[{slots['area']}]")
    if rng.random() < 0.5:
        mr_parts.append(f"familyFriendly[{slots['family']}]")
    if rng.random() < 0.5:
        mr_parts.append(f"near[{slots['near']}]")
    mr = " , ".join(mr_parts)
    tpl = rng.choice(_TEMPLATES)
    ref = tpl.format(family_txt="family friendly" if slots["family"] == "yes"
                     else "non family friendly", **slots)
    return Example(mr=mr, ref=ref)


def generate(n: int, seed: int = 0) -> List[Example]:
    rng = random.Random(seed)
    return [_one(rng) for _ in range(n)]


def e2e_splits(train: int = 42000, val: int = 4600, test: int = 4600,
               seed: int = 0) -> Tuple[List[Example], List[Example], List[Example]]:
    return (generate(train, seed), generate(val, seed + 1),
            generate(test, seed + 2))
