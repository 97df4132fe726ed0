# -*- coding: utf-8 -*-
"""Deterministic Penn-Treebank-style POS tagger for G2P disambiguation.

The reference resolves heteronyms ("record" the noun vs "record" the verb)
with spaCy's en_core_web_sm tagger (reference:
src/illufly_tts/core/g2p/english_g2p.py:587-593) and keys lexicon entries by
tag with a VERB/NOUN/ADV/ADJ parent-tag fallback (english_g2p.py:253-293).
spaCy is not available in this environment, and a 12 MB statistical model is
the wrong tool for the 6 tag distinctions G2P actually consumes. This module
is a purpose-built deterministic tagger: a closed-class lexicon plus
suffix-shape guesses, disambiguated by ordered context rules (the same
signal a statistical tagger extracts from these positions, but auditable
and version-stable — SURVEY §7 hard-part #4 pins frontend fidelity on
deterministic behavior).

Consumers need exactly:
- VERB vs NOUN vs ADJ parent tags for tag-keyed heteronym entries
- DT ("a"), PRP ("I"), TO/IN ("to", "in"), ADV ("by"), VBD/VBN tense for
  "read"/"used", NNP for letter-spelling
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence

# --- closed-class lexicon ----------------------------------------------------

DETERMINERS = {
    "the", "a", "an", "this", "that", "these", "those", "each", "every",
    "either", "neither", "some", "any", "no", "another", "such",
    "more", "less", "most", "least", "much", "fewer",
}
PRP_SUBJECT = {"i", "we", "they", "you", "he", "she", "it"}
PRP_OBJECT = {"me", "us", "them", "him", "her", "myself", "yourself",
              "himself", "herself", "itself", "ourselves", "themselves"}
POSSESSIVES = {"my", "your", "his", "her", "its", "our", "their", "whose"}
MODALS = {"will", "would", "can", "could", "shall", "should", "may",
          "might", "must", "wo", "ca", "sha"}  # wo/ca/sha from won't/can't
BE_FORMS = {"am", "is", "are", "was", "were", "be", "been", "being",
            "'s", "'re", "'m"}
HAVE_FORMS = {"have", "has", "had", "having", "'ve", "'d"}
DO_FORMS = {"do", "does", "did"}
PREPOSITIONS = {
    "of", "in", "on", "at", "by", "for", "with", "about", "against",
    "between", "into", "through", "during", "before", "after", "above",
    "below", "from", "up", "down", "out", "off", "over", "under", "near",
    "without", "within", "along", "across", "behind", "beyond", "toward",
    "towards", "upon", "among", "around", "per", "via", "despite", "unless",
    "until", "since", "than", "as", "like",
}
CONJUNCTIONS = {"and", "or", "but", "nor", "so", "yet"}
SUBORDINATORS = {"because", "although", "though", "while", "whereas", "if",
                 "when", "whenever", "where", "wherever", "that", "whether"}
ADVERBS = {
    "not", "n't", "very", "too", "also", "just", "now", "then", "here",
    "there", "always", "never", "often", "sometimes", "usually", "again",
    "already", "still", "soon", "quite", "rather", "almost", "even",
    "only", "really", "well", "perhaps", "maybe", "however", "instead",
    "away", "back", "together", "yesterday", "today", "tomorrow",
    "please", "later", "earlier", "outside", "inside", "indoors",
    "outdoors", "upstairs", "downstairs", "downtown", "abroad",
    "overseas", "nearby", "elsewhere", "overnight", "tonight",
}
WH_WORDS = {"who": "WP", "whom": "WP", "what": "WP", "which": "WDT",
            "why": "WRB", "how": "WRB"}
# frequent irregular verbs whose base form is not guessable from shape
COMMON_VERBS = {
    "go", "come", "get", "make", "take", "see", "know", "think", "say",
    "tell", "give", "find", "want", "need", "try", "let", "put", "keep",
    "begin", "seem", "help", "show", "hear", "run", "move", "believe",
    "bring", "happen", "write", "sit", "stand", "lose", "pay", "meet",
    "include", "continue", "set", "learn", "change", "lead", "understand",
    "hurt", "cost", "answer", "listen", "roam", "work", "play", "cover",
    "speak", "read", "spend", "grow", "open", "walk", "win", "teach",
    "offer", "remember", "consider", "appear", "buy", "serve", "send",
    "build", "stay", "fall", "cut", "reach", "kill", "raise", "eat",
    "went", "came", "got", "made", "took", "saw", "knew", "thought",
    "said", "told", "gave", "found", "wanted", "needed", "tried",
    "kept", "began", "seemed", "helped", "showed", "heard", "ran",
    "moved", "believed", "brought", "wrote", "sat", "stood", "lost",
    "paid", "met", "spoke", "spent", "grew", "opened", "walked", "won",
    "taught", "bought", "sent", "built", "stayed", "fell", "ate",
}
FLAT_ADVERBS = {"hard", "fast", "high", "low", "late", "early", "deep",
                "long", "straight", "tight", "loud", "slow", "quick"}
# comparative/superlative adverbs after a verb ("runs faster",
# "works best", "tastes better after exercise")
CMP_ADVERBS = {"faster", "slower", "better", "best", "worse", "worst",
               "harder", "longer", "sooner", "higher", "deeper",
               "louder", "earlier"}
# -ing words that are lexical nouns, not gerunds (shape rule would
# tag them VBG)
ING_NOUNS = {"evening", "morning", "ceiling", "building", "clothing",
             "wedding", "feeling", "meeting", "painting", "drawing",
             "housing", "lightning", "pudding", "herring", "sibling",
             "duckling", "dumpling", "darling", "shilling", "viking",
             "warning", "opening", "beginning", "ending", "gathering"}
# participial adjectives: attributive -ing modifiers of a nominal
# ("boring tasks", "a surprising result")
PARTICIPIAL_ADJ = {"boring", "interesting", "exciting", "amazing",
                   "amusing", "annoying", "confusing", "charming",
                   "lasting", "missing", "outstanding", "promising",
                   "striking", "surprising", "willing", "loving",
                   "caring", "daring", "leading", "winning", "fighting"}
PLURAL_NOUNS = {"people", "police", "cattle", "fish", "sheep", "deer",
                "children", "men", "women", "feet", "teeth", "mice"}

# past-tense/perfect auxiliaries that force VBN/VBD on an ambiguous verb
PAST_AUX = HAVE_FORMS | {"was", "were", "been"}
LINKING_VERBS = {"seem", "seems", "seemed", "look", "looks", "looked",
                 "feel", "feels", "felt", "sound", "sounds", "sounded",
                 "smell", "smells", "taste", "tastes", "appear", "appears",
                 "appeared", "become", "becomes", "became", "remain",
                 "remains", "remained", "stay", "stays", "stayed", "grew",
                 "turned", "get", "gets"}

# indefinite pronouns (parent family None, like PRP)
INDEF_PRONOUNS = {
    "everything", "everyone", "everybody", "something", "someone",
    "somebody", "anything", "anyone", "anybody", "nothing", "nobody",
    "none", "all", "both", "few", "many", "several", "most", "one",
    "other", "others", "anywhere", "everywhere", "somewhere", "nowhere",
}
NUMBER_WORDS = {
    "zero", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen", "twenty", "thirty",
    "forty", "fifty", "sixty", "seventy", "eighty", "ninety", "hundred",
    "thousand", "million", "billion", "trillion", "first", "second",
    "third", "half", "dozen",
}
# common monomorphemic adjectives whose shape gives no -ous/-ful/... cue;
# curated to EXCLUDE heteronym words (live, close, content, minute, ...)
# so tag-keyed resolution stays context-driven for those
COMMON_ADJECTIVES = {
    "quick", "brown", "lazy", "big", "small", "large", "tiny", "huge",
    "tall", "short", "long", "wide", "narrow", "deep", "shallow", "high",
    "low", "old", "young", "new", "fresh", "stale", "ancient", "modern",
    "good", "bad", "fine", "great", "poor", "rich", "wealthy", "cheap",
    "expensive", "free", "busy", "idle", "fast", "slow", "rapid", "swift",
    "hot", "cold", "warm", "cool", "icy", "frozen", "mild", "bitter",
    "sweet", "sour", "salty", "spicy", "bland", "tasty", "ripe", "raw",
    "hard", "soft", "firm", "loose", "tight", "stiff", "smooth", "rough",
    "sharp", "dull", "blunt", "heavy", "light", "dark", "bright", "dim",
    "pale", "vivid", "clean", "dirty", "neat", "messy", "tidy", "wet",
    "dry", "damp", "moist", "empty", "full", "hollow", "solid", "dense",
    "thick", "thin", "fat", "slim", "lean", "strong", "weak", "tough",
    "fragile", "sturdy", "flimsy", "happy", "sad", "angry", "calm",
    "nervous", "anxious", "eager", "proud", "humble", "shy", "bold",
    "brave", "timid", "fierce", "gentle", "kind", "cruel", "mean",
    "friendly", "hostile", "polite", "rude", "foul", "honest", "loyal", "greedy",
    "jealous", "curious", "clever", "smart", "wise", "foolish", "stupid",
    "dumb", "silly", "crazy", "sane", "strange", "weird", "odd", "normal",
    "common", "rare", "usual", "typical", "unique", "special", "plain",
    "fancy", "simple", "easy", "tricky", "tough", "quiet", "loud",
    "noisy", "silent", "early", "late", "recent", "sudden", "gradual",
    "brief", "quick", "slow", "near", "far", "distant", "local", "remote",
    "inner", "outer", "upper", "lower", "main", "chief", "prime", "major",
    "minor", "vital", "crucial", "key", "basic", "core", "pure", "mere",
    "true", "false", "real", "fake", "right", "wrong", "exact", "rough",
    "vague", "clear", "plain", "obvious", "subtle", "sick", "ill",
    "healthy", "fit", "tired", "weary", "awake", "asleep", "alive",
    "dead", "blind", "deaf", "mute", "lame", "hungry", "thirsty",
    "careful", "careless", "skilled", "tender", "crisp", "steep",
    "rocky", "sandy", "muddy", "grassy", "leafy", "woody", "hilly",
    "rainy", "sunny", "cloudy", "windy", "snowy", "foggy", "stormy",
    "misty", "humid", "arid", "lush", "barren", "fertile", "wild",
    "tame", "fierce", "savage", "grand", "noble", "royal", "sacred",
    "holy", "evil", "wicked", "guilty", "innocent", "legal", "illegal",
    "fair", "unfair", "equal", "level", "flat", "round", "square",
    "curved", "straight", "crooked", "bent", "broken", "whole", "entire",
    "partial", "double", "single", "triple", "extra", "spare", "quiet",
    "still", "lively", "vivid", "dull", "drab", "colorful", "golden",
    "silver", "gray", "grey", "red", "blue", "green", "yellow", "pink",
    "purple", "orange", "black", "white", "blond", "blonde", "bald",
    "hairy", "furry", "fuzzy", "sleek", "shiny", "glossy", "rusty",
    "dusty", "angry", "glad", "sorry", "keen", "fond", "proud", "vain",
    "stern", "strict", "harsh", "severe", "next", "last", "own", "same",
    "difficult", "patient", "open", "steady", "lenient", "gloomy",
    "cheerful",
    "merry", "jolly", "grim", "somber", "solemn", "playful", "serious",
    "earnest", "frank", "blunt", "candid", "sly", "cunning", "shrewd",
}
# irregular preterites not covered by the -ed shape guess
IRREGULAR_PAST = {
    "rose", "rang", "froze", "drove", "rode", "sang", "swam", "threw",
    "flew", "drew", "wore", "tore", "chose", "broke", "stole", "woke",
    "shook", "caught", "fought", "sought", "held", "fed", "bled", "bred",
    "slid", "stuck", "struck", "swung", "hung", "dug", "spun", "sank",
    "drank", "shrank", "sprang", "forgot", "forgave", "slept", "crept",
    "wept", "leapt", "dealt", "knelt", "dreamt", "lent", "bent", "shone",
    "hid", "lit", "quit", "burst", "slew",
    "withdrew", "arose", "awoke", "blew", "swore", "swept", "clung",
    "flung", "strove", "throve", "trod", "wrung", "laid", "fled", "sold",
}

_NUM_RE = re.compile(r"^[+-]?\d[\d,]*\.?\d*$")
_PUNCT_TAG = {
    "(": "-LRB-", ")": "-RRB-", ",": ",", ".": ".", "!": ".", "?": ".",
    ";": ":", ":": ":", "—": ":", "-": ":", '"': "''", "“": "``",
    "”": "''", "…": ".",
}


def _closed_class(lower: str) -> Optional[str]:
    if lower in DETERMINERS:
        return "DT"
    if lower in PRP_SUBJECT or lower in PRP_OBJECT:
        return "PRP"
    if lower in POSSESSIVES:
        return "PRP$"
    if lower in MODALS:
        return "MD"
    if lower in BE_FORMS or lower in DO_FORMS:
        # tag be/do forms as verbs; tense detail is irrelevant to consumers
        return "VBZ" if lower in ("is", "does", "'s") else "VBP"
    if lower in HAVE_FORMS:
        return "VBP"
    if lower == "to":
        return "TO"
    if lower in PREPOSITIONS:
        return "IN"
    if lower in CONJUNCTIONS:
        return "CC"
    if lower in SUBORDINATORS:
        return "IN"
    if lower in ADVERBS:
        return "RB"
    if lower in WH_WORDS:
        return WH_WORDS[lower]
    if lower in INDEF_PRONOUNS:
        return "PRP"
    if lower in NUMBER_WORDS:
        return "CD"
    # 'there' tags RB via ADVERBS above; no consumer keys on EX, so the
    # existential reading needs no separate tag
    return None


def _shape_guess(word: str, lower: str, sentence_initial: bool) -> str:
    """Open-class guess from orthography alone (may be overridden by
    context rules)."""
    if word[:1].isupper() and not sentence_initial:
        return "NNP"
    if lower.endswith("ly") and len(lower) > 4:
        return "RB"
    if lower in ING_NOUNS:
        return "NN"
    if lower.endswith("ing") and len(lower) > 5:
        return "VBG"
    if lower.endswith(("tion", "sion", "ment", "ness", "ship", "ance",
                       "ence", "ity", "ism", "ist", "ure", "age", "hood")):
        return "NN"
    if lower.endswith(("ous", "ful", "less", "ive", "able", "ible",
                       "ary")) or (lower.endswith(("ish", "al", "id"))
                                   and len(lower) > 4):
        return "JJ"
    if lower in PLURAL_NOUNS:
        return "NNS"
    if lower in COMMON_ADJECTIVES:
        return "JJ"
    if lower in IRREGULAR_PAST:
        return "VBD"
    if lower.endswith("ed") and len(lower) > 3:
        return "VBD"
    if lower in COMMON_VERBS:
        return "VB"
    if lower.endswith("s") and not lower.endswith("ss") and len(lower) > 3:
        return "NNS"
    return "NN"


def tag_words(words: Sequence[str]) -> List[str]:
    """Tag a token sequence (words and punctuation marks).

    Two passes: shape/lexicon guesses, then ordered context rules walking
    left-to-right (each rule fires only on words the lexicon did not pin)."""
    n = len(words)
    tags: List[str] = []
    fixed: List[bool] = []  # closed-class decisions are final
    sentence_start = True
    for word in words:
        if not word or not any(c.isalpha() for c in word):
            if _NUM_RE.match(word or ""):
                tags.append("CD")
            else:
                tags.append(_PUNCT_TAG.get(word, "NFP"))
            fixed.append(True)
            if word in (".", "!", "?", "…"):
                sentence_start = True
            continue
        lower = word.lower()
        closed = _closed_class(lower)
        if closed is not None:
            tags.append(closed)
            fixed.append(True)
        else:
            tags.append(_shape_guess(word, lower, sentence_start))
            fixed.append(False)
        sentence_start = False

    _PUNCT_TAGS = (".", ",", ":", "NFP", "``", "''", "-LRB-", "-RRB-")

    def prev_real_idx(i: int) -> int:
        for j in range(i - 1, -1, -1):
            if tags[j] not in _PUNCT_TAGS:
                return j
        return -1

    def prev_real(i: int):
        """Last non-punctuation (word, tag) before position i."""
        j = prev_real_idx(i)
        if j < 0:
            return None, None
        return words[j].lower(), tags[j]

    def clause_has_finite(i: int) -> bool:
        """A finite verb already sits in this clause (scan back to the
        last sentence punctuation or coordinator): the NNS/NN at i is
        then an object, not a second predicate ('cities permit street
        vendors' — vendors stays nominal)."""
        for j in range(i - 1, -1, -1):
            if tags[j] in (".", ":", "CC") or words[j] in (";",):
                return False
            if tags[j] in ("VBZ", "VBP", "VBD") or tags[j] == "MD":
                return True
        return False

    for i in range(n):
        if fixed[i]:
            continue
        word = words[i]
        lower = word.lower()
        pw, pt = prev_real(i)
        # context rules, most specific first
        if pw is None and tags[i] == "NN" and i + 1 < n and (
            tags[i + 1] in ("DT", "PRP$", "PRP")
        ):
            # clause-initial word heading a noun phrase or pronoun:
            # imperative ("Close the door", "Permit me")
            tags[i] = "VB"
        elif pt == "RB" and tags[i] == "NN" and i + 1 < n and (
            tags[i + 1] in ("DT", "PRP$")
        ):
            # adverb-led imperative: "please close the door"
            tags[i] = "VB"
        elif lower in PARTICIPIAL_ADJ and tags[i] == "VBG" and \
                i + 1 < n and tags[i + 1] in ("NN", "NNS", "NNP"):
            # attributive participial adjective: "boring tasks"
            tags[i] = "JJ"
        elif pt in ("TO", "MD") or pw in DO_FORMS:
            nxt = tags[i + 1] if i + 1 < n else None
            if tags[i] == "JJ" and nxt in ("NN", "NNS", "NNP", "JJ"):
                pass  # prepositional to + NP: "to digital formats"
            elif pt == "TO" and tags[i] in ("NN", "NNP") and \
                    lower not in COMMON_VERBS and (
                        nxt is None or nxt in ("IN", ".", ",", "NFP")
                    ) and (
                        tags[prev_real_idx(prev_real_idx(i))]
                        if prev_real_idx(prev_real_idx(i)) >= 0 else ""
                    ) in ("NN", "NNS", "NNP"):
                # prepositional to (nominal before it): "grain to asia";
                # a verb before 'to' means infinitive ("refuse to
                # surrender") and falls through to VB
                pass
            else:
                # "to record", "will record", "didn't record" -> verb base
                tags[i] = "VB"
        elif pw in PAST_AUX and (
            lower.endswith(("ed", "en")) or lower in COMMON_VERBS
            or lower in IRREGULAR_PAST
        ):
            # "has recorded", "was read" -> past participle
            tags[i] = "VBN"
        elif pw in LINKING_VERBS and not lower.endswith("ing"):
            # predicative complement of a linking verb: "seemed content"
            # — except comparative adverbs ("tastes better after...")
            if lower in CMP_ADVERBS:
                tags[i] = "RB"
            elif tags[i] not in ("NNS", "NNP"):
                tags[i] = "JJ"
        elif pw in BE_FORMS:
            # "is recording" kept by shape; "is live" -> adjective; a
            # clear noun-morphology complement stays nominal ("was
            # freedom", "is happiness")
            if lower.endswith("ing"):
                tags[i] = "VBG"
            elif not lower.endswith(("dom", "tion", "sion", "ness",
                                     "ment", "ship", "hood", "ity")):
                tags[i] = "JJ"
        elif pt in ("DT", "PRP$") and lower.endswith("ate") and \
                tags[i] == "NN" and i + 1 < n and tags[i + 1] == "NN":
            # prenominal -ate modifier: "a moderate climate", "his
            # separate office" (heteronym words can't sit in
            # COMMON_ADJECTIVES — tag-keyed readings need context)
            tags[i] = "JJ"
        elif pt in ("DT", "PRP$", "JJ", "CD"):
            # "the record", "my record", "a close call" -> nominal; keep
            # plural and proper-noun shape, and keep JJ when the *next*
            # word is itself nominal ("a live concert")
            nxt_tag = tags[i + 1] if i + 1 < n else None
            if tags[i] == "JJ" and nxt_tag in ("NN", "NNS", "NNP", "JJ"):
                pass  # attributive adjective survives ("quick brown fox")
            elif tags[i] == "VBD" and nxt_tag in ("NN", "NNS", "NNP", "JJ"):
                tags[i] = "JJ"  # "a deserted desert", "the painted wall"
            elif tags[i] not in ("NNS", "NNP"):
                tags[i] = "NN"
        elif pt == "PRP" and pw in PRP_SUBJECT:
            # "they record", "I present" -> finite verb
            tags[i] = "VBZ" if lower.endswith("s") else "VBP"
        elif pt == "NNS" and tags[i] == "JJ" and i + 1 < n and (
            tags[i + 1] == "IN"
        ) and lower in ("live",):
            # plural subject + heteronym shape-guessed JJ + preposition:
            # "fish live in clean water"
            tags[i] = "VBP"
        elif pt and pt.startswith("VB") and (
            lower in FLAT_ADVERBS or lower in CMP_ADVERBS
        ) and (
            i + 1 >= n or tags[i + 1] in ("IN", "DT", "PRP", "PRP$", "CD",
                                          ".", ",", "CC", "NFP")
        ):
            # flat/comparative adverbs: "blew hard", "runs faster than me"
            tags[i] = "RB"
        elif pt and pt.startswith("VB") and tags[i] == "VBG" and (
            i + 1 >= n or tags[i + 1] not in ("NN", "NNS", "NNP", "JJ")
        ):
            # gerund object: "they permit smoking (outside)" -> nominal
            tags[i] = "NN"
        elif pt == "RB":
            # subject + adverb + predicate: "people rarely lie",
            # "medicine often works best"
            j2 = prev_real_idx(prev_real_idx(i))
            t2 = tags[j2] if j2 >= 0 else None
            if t2 in ("NN", "NNP") and tags[i] == "NNS" and \
                    lower.endswith("s"):
                tags[i] = "VBZ"
            elif t2 in ("NNS", "PRP") and tags[i] in ("NN", "VB"):
                tags[i] = "VBP"
        elif pt == "IN":
            nxt_tag = tags[i + 1] if i + 1 < n else None
            if tags[i] == "JJ" and nxt_tag in ("NN", "NNS", "NNP", "JJ"):
                pass  # "in clean water"
            elif tags[i] not in ("NNS", "NNP", "VBG"):
                tags[i] = "NN"
        elif pt in ("NN", "NNP") and tags[i] == "NNS" and i + 1 < n and (
            tags[i + 1] in ("RB", "IN", "DT", "PRP$", "JJ", "NN", "NNS",
                            "PRP", "CD", ".", ",")
        ) and not clause_has_finite(i):
            # singular subject + s-form: "the fox jumps over ...",
            # "coffee keeps me awake", "climate suits grapes"
            tags[i] = "VBZ"
        elif pt == "NNS" and tags[i] in ("NN", "VB") and i + 1 < n and (
            tags[i + 1] in ("RB", "IN", "DT", "PRP$", "JJ", "CD", "TO",
                            "NN", "NNS", "VBG", ".", ",")
        ) and not clause_has_finite(i):
            # plural subject + verb: "muscles contract quickly",
            # "these results conflict with ours". Keyed on what FOLLOWS
            # (adverb/preposition/clause end) so noun compounds headed by
            # a plural ("sports contract was...") stay nominal.
            tags[i] = "VBP"
        # NOTE: no bare "noun noun -> verb" rule: English noun compounds
        # ("software update") are far commoner than bare-plural-subject
        # clauses, so nominal stays the default reading
    return tags


def parent_tag(tag: Optional[str]) -> Optional[str]:
    """Collapse to the families lexicon entries key on (reference
    english_g2p.py:253-265)."""
    if tag is None:
        return None
    if tag.startswith("VB"):
        return "VERB"
    if tag.startswith("NN"):
        return "NOUN"
    if tag.startswith("RB") or tag.startswith("ADV"):
        return "ADV"
    if tag.startswith("JJ") or tag.startswith("ADJ"):
        return "ADJ"
    return tag
