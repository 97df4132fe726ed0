# -*- coding: utf-8 -*-
"""Mandarin tone sandhi.

Fresh implementation of the rule inventory surveyed from the reference's
``ToneSandhi`` (reference: src/illufly_tts/core/g2p/tone_sandhi.py:26-385,
itself adapted from PaddleSpeech, Apache-2.0):

- 不: bu2 before tone 4; neutral inside X不Y verb complements (看不懂).
- 一: neutral between reduplicated verbs (看一看); yi1 in ordinals (第一)
  and digit sequences; yi2 before tone 4/5; yi4 otherwise.
- neutral tone: sentence particles, 的地得, aspect markers 了着过,
  们/子 suffixes, locatives 上/下, directionals 来/去 after 上下进出回过起开,
  classifier 个 after numerals/几有两半多各整每做是, reduplicated n/v/a
  syllables, and a ~430-word neutral-tone vocabulary (checked whole-word and
  on each jieba sub-word).
- third tone: 2-char all-3rd -> 2nd+3rd; 3-char words split by jieba
  sub-word structure (disyllabic+mono vs mono+disyllabic); 4-char idioms
  split 2+2; partial runs handled at the sub-word boundary.

Segmentation pre-merges (reference :222-372): attach 不/一 to their
neighbours, merge reduplications, merge short all-3rd-tone neighbours (both
the whole-word and boundary variants), attach 儿.

Operates on "finals" lists like ``['uo3', 'men5']`` (tone digit last).
The word-structure splits use jieba's search-mode segmentation; tones for
the pre-merge checks come from our own pinyin engine.
"""
from __future__ import annotations

from typing import List, Tuple

import jieba

from .pinyin.engine import word_pinyin

# (word, pos, finals-in) -> finals-out memo; see modified_tone
_MT_CACHE: dict = {}
_MT_CACHE_MAX = 100_000


def clear_sandhi_cache() -> None:
    _MT_CACHE.clear()

# Sentence-final particles read neutral (reference :106).
_PARTICLES = "吧呢啊呐噻嘛吖嗨哦哒滴哩哟喽啰耶喔诶呀哇啦咧嘞"
_DE = "的地得"
_ASPECT = "了着过"
_ASPECT_POS = {"ul", "uz", "ug"}
_LOCATIVE_POS = {"s", "l", "f"}
_PUNC = "、：，；。？！“”‘’':,;.?!"

# Words whose final 子/们 (or reduplication) is a full morpheme, never
# neutral (physics terms, literary reduplications, etc.).
MUST_NOT_NEURAL = {
    "男子", "女子", "电子", "原子", "分子", "量子", "离子", "质子", "中子",
    "莲子", "石子", "瓜子", "学子", "算子", "因子", "粒子", "孢子", "精子",
    "卵子", "种子", "核子", "光子", "王子", "份子", "独生子",
    "人人", "虎虎", "幺幺", "哈哈", "数数", "袅袅", "熙熙", "攘攘",
    "想想", "死死", "冉冉", "恳恳", "佼佼", "吵吵", "打打", "考考",
    "整整", "莘莘", "青青", "干嘛", "局地", "以下", "留得", "耕地",
    "落地", "娃哈哈", "花花草草", "家家户户",
}

# Standard-Mandarin neutral-tone vocabulary (last syllable neutral).
# Authored by category; the inventory matches the dictionaries' 轻声 words
# (the same set the reference carries at tone_sandhi.py:31-76).
MUST_NEURAL = set("""
一辈 丈人 丈夫 上司 上头 下巴 下水 不由 世故 东家 东西 两口 丧气 丫头
主意 买卖 事情 云彩 交情 亲家 亲戚 人们 人家 什么 介绍 他们 休息 伙计
伶俐 伺候 似的 位置 体面 作坊 你们 佩服 使唤 便宜 倒腾 值得 兄弟 先生
光景 免得 关系 养活 冒失 冤家 冤枉 冷战 凉快 凑合 几个 凤凰 出息 分析
利害 利索 利落 别人 别扭 刺激 刺猬 前头 力气 功夫 动弹 动静 勤快 匀称
包涵 包袱 千斤 厚道 叔叔 口袋 叫唤 吆喝 合同 合计 吉他 名堂 名字 名气
后头 吓唬 吩咐 含糊 告示 告诉 和尚 咕噜 咖喱 咱们 咳嗽 哆嗦 哈欠 哑巴
哥们 哥哥 哪个 唾沫 商量 啰嗦 喇叭 喇嘛 喉咙 喜欢 喽啰 嘀咕 嘟囔 嘱咐
嘴巴 困难 在乎 地方 地道 壮实 外甥 多么 多少 大人 大夫 大意 大方 大爷
太太 太阳 头发 女婿 奴才 奶奶 她们 妈妈 妖精 妥当 妯娌 妹妹 姐夫 姐姐
姑娘 委屈 姥姥 姥爷 娃娃 娇气 娘们 娘家 婆家 婶婶 媒人 媳妇 嫁妆 字号
学问 孩子 它们 官司 实在 客气 家伙 寒碜 寡妇 对付 对头 将军 将就 小伙
小气 少爷 尾巴 屁股 岁数 工夫 差事 巴掌 巴结 师傅 师父 希罕 帐篷 帮手
干事 年头 幸福 庄稼 应酬 开通 弄堂 弟兄 弟弟 张罗 得罪 心思 志气 忙活
快活 念叨 念头 怎么 思量 怪物 悟性 惦记 意思 意识 懂得 懒得 戏弄 我们
戒指 扁担 扎实 扑腾 打发 打听 打扮 打算 打量 扫帚 扫把 折腾 护士 报复
抬举 拉扯 拖沓 招呼 招牌 拨弄 拳头 拾掇 指头 指甲 挑剔 挖苦 掂量 提防
摆弄 收成 收拾 故事 新鲜 早上 时候 时辰 明白 显得 晌午 晓得 晚上 暖和
月亮 月饼 朋友 木匠 木头 本事 机灵 枇杷 枕头 架势 柴火 栅栏 核桃 棉花
棒槌 棺材 槟榔 模糊 欺负 正经 母亲 比方 毛病 泥鳅 活泼 浪头 消息 清楚
温和 溜达 滑溜 漂亮 火候 灯笼 炊帚 点心 烂糊 烟筒 烧饼 热闹 照应 照顾
熟悉 爱人 父亲 爷们 爷爷 爸爸 爽快 牌楼 牙碜 牢骚 牲口 特务 状元 狐狸
玄乎 玫瑰 玻璃 琉璃 琢磨 琵琶 甘蔗 甜头 生意 畜生 疏忽 疙瘩 疟疾 痛快
痢疾 白净 盘算 盘缠 相声 相好 盼头 省得 眉毛 眨巴 眯缝 眼睛 知识 石匠
石头 石榴 码头 砚台 礼拜 祖宗 福气 秀才 秀气 秧歌 称呼 稀罕 稳当 窗户
窝囊 窟窿 笑话 笑语 笤帚 答应 算盘 算计 篱笆 簸箕 粮食 精神 糊涂 糟蹋
糨糊 累赘 红火 结实 编辑 缘故 罐头 罗嗦 翻腾 老婆 老实 老爷 耳朵 耷拉
耽搁 耽误 聪明 胡同 胡琴 胡萝 胭脂 胳膊 能耐 脊梁 脑袋 脾气 膏药 自在
舅舅 舌头 舒坦 舒服 芝麻 苍蝇 苗头 苗条 荒唐 荸荠 菩萨 萝卜 葡萄 葫芦
薄荷 蘑菇 蚂蚱 蛤蟆 蜡烛 行当 行李 街坊 衙门 衣服 衣裳 补丁 裁缝 要么
见识 规矩 觉得 计划 认得 认识 记号 记得 记性 讲究 豆腐 财主 费用 趔趄
跟头 跳蚤 踏实 转悠 软和 过去 运气 这个 这么 连累 迷糊 造化 逻辑 道士
邋遢 那个 那么 部分 里头 里脊 钟头 钥匙 铁匠 铃铛 铺盖 锄头 门道 闺女
阔气 队伍 难为 风筝 馄饨 馒头 首饰 马虎 骆驼 骨头 高粱 鸳鸯 麻利 麻烦
""".split())

_X_ENG = frozenset(("x", "eng"))


def _tone(final: str) -> str:
    return final[-1] if final and final[-1].isdigit() else ""


def _set_tone(final: str, tone: str) -> str:
    if final and final[-1].isdigit():
        return final[:-1] + tone
    return final + tone


def _word_tones(word: str) -> List[str]:
    """Tone digit per char via our pinyin engine ('5' when unknown)."""
    out = []
    for syl in word_pinyin(word):
        out.append(syl[-1] if syl and syl[-1].isdigit() else "5")
    return out


def _all_tone_three(finals: List[str]) -> bool:
    return bool(finals) and all(_tone(f) == "3" for f in finals)


def _split_word(word: str) -> List[str]:
    """Split a word into two sub-words at jieba's search-mode boundary
    (reference :79-90): the shortest search-mode token anchors the split."""
    subs = sorted(jieba.cut_for_search(word), key=len)
    if not subs:
        return [word]
    first = subs[0]
    idx = word.find(first)
    if idx == 0:
        return [first, word[len(first):]]
    return [word[: -len(first)], first]


class ToneSandhi:
    # --- segmentation pre-merges (reference :222-372) -----------------------

    def _merge_bu(self, seg):
        """Attach a standalone 不 to the following word."""
        out = []
        for i, (word, pos) in enumerate(seg):
            if out and out[-1][0] == "不" and pos not in _X_ENG:
                out[-1] = ("不" + word, pos)
            else:
                out.append((word, pos))
        # a trailing bare 不 stays
        return out

    def _merge_yi(self, seg):
        """V 一 V -> V一V; then attach a leading 一 to the following word."""
        out = []
        i = 0
        while i < len(seg):
            word, pos = seg[i]
            if (
                word == "一" and out and i + 1 < len(seg)
                and out[-1][0] == seg[i + 1][0]
                and out[-1][1] == "v" and seg[i + 1][1] not in _X_ENG
            ):
                out[-1] = (out[-1][0] + "一" + seg[i + 1][0], out[-1][1])
                i += 2
                continue
            out.append((word, pos))
            i += 1
        merged = []
        for word, pos in out:
            if merged and merged[-1][0] == "一" and pos not in _X_ENG:
                merged[-1] = ("一" + word, pos)
            else:
                merged.append((word, pos))
        return merged

    def _merge_reduplication(self, seg):
        out = []
        for word, pos in seg:
            if out and word == out[-1][0] and pos not in _X_ENG:
                out[-1] = (out[-1][0] + word, out[-1][1])
            else:
                out.append((word, pos))
        return out

    @staticmethod
    def _is_reduplication(word: str) -> bool:
        return len(word) == 2 and word[0] == word[1]

    def _merge_three_tones(self, seg, boundary_only: bool):
        """Merge neighbours so third-tone sandhi sees the whole run.
        boundary_only=False: both words entirely 3rd tone (reference
        :271-303); True: only the boundary chars 3rd tone (:309-340)."""
        tones = [
            ["0"] if pos in _X_ENG else _word_tones(word)
            for word, pos in seg
        ]
        out = []
        merged_prev = False
        for i, (word, pos) in enumerate(seg):
            if i > 0 and pos not in _X_ENG and not merged_prev:
                prev_t, cur_t = tones[i - 1], tones[i]
                if boundary_only:
                    hit = prev_t[-1] == "3" and cur_t[0] == "3"
                else:
                    hit = all(t == "3" for t in prev_t) and all(
                        t == "3" for t in cur_t
                    )
                if (
                    hit
                    and not self._is_reduplication(seg[i - 1][0])
                    and len(seg[i - 1][0]) + len(word) <= 3
                    and out
                ):
                    out[-1] = (out[-1][0] + word, out[-1][1])
                    merged_prev = True
                    continue
            merged_prev = False
            out.append((word, pos))
        return out

    def _merge_er(self, seg):
        out = []
        for word, pos in seg:
            if word == "儿" and out and out[-1][1] not in _X_ENG:
                out[-1] = (out[-1][0] + "儿", out[-1][1])
            else:
                out.append((word, pos))
        return out

    def pre_merge_for_modify(
        self, seg: List[Tuple[str, str]]
    ) -> List[Tuple[str, str]]:
        seg = self._merge_bu(seg)
        seg = self._merge_yi(seg)
        seg = self._merge_reduplication(seg)
        seg = self._merge_three_tones(seg, boundary_only=False)
        seg = self._merge_three_tones(seg, boundary_only=True)
        seg = self._merge_er(seg)
        return seg

    # --- individual rules ---------------------------------------------------

    def _bu_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if len(word) == 3 and word[1] == "不" and len(finals) == 3:
            finals[1] = _set_tone(finals[1], "5")  # 看不懂 / 来不及
            return finals
        for i, char in enumerate(word):
            if char != "不" or i >= len(finals):
                continue
            if i + 1 < len(finals) and _tone(finals[i + 1]) == "4":
                finals[i] = _set_tone(finals[i], "2")  # 不是 bu2
        return finals

    def _yi_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if "一" not in word or len(finals) != len(word):
            return finals
        # digit sequences read yi1: 一零零, 二一零
        others = [c for c in word if c != "一"]
        if others and all(c.isnumeric() for c in others):
            return finals
        if len(word) == 3 and word[1] == "一" and word[0] == word[2]:
            finals[1] = _set_tone(finals[1], "5")  # 看一看
            return finals
        if word.startswith("第一"):
            finals[1] = _set_tone(finals[1], "1")
            return finals
        for i, char in enumerate(word):
            if char != "一" or i + 1 >= len(word):
                continue
            if _tone(finals[i + 1]) in ("4", "5"):
                finals[i] = _set_tone(finals[i], "2")  # 一个 yi2ge4
            elif word[i + 1] not in _PUNC:
                finals[i] = _set_tone(finals[i], "4")  # 一天 yi4tian1
        return finals

    def _neural_sandhi(
        self, word: str, pos: str, finals: List[str]
    ) -> List[str]:
        if not finals or len(finals) != len(word):
            return finals
        if word in MUST_NOT_NEURAL:
            return finals
        # reduplication: 爸爸, 看看, 旺旺
        for j in range(1, len(word)):
            if word[j] == word[j - 1] and pos[:1] in ("n", "v", "a"):
                finals[j] = _set_tone(finals[j], "5")
        ge_idx = word.find("个")
        if word[-1] in _PARTICLES or word[-1] in _DE:
            finals[-1] = _set_tone(finals[-1], "5")
        elif len(word) == 1 and word in _ASPECT and pos in _ASPECT_POS:
            finals[-1] = _set_tone(finals[-1], "5")  # 走了, 看着, 去过
        elif len(word) > 1 and word[-1] in "们子" and pos in ("r", "n") \
                and word not in MUST_NOT_NEURAL:
            finals[-1] = _set_tone(finals[-1], "5")
        elif len(word) > 1 and word[-1] in "上下" and pos in _LOCATIVE_POS:
            finals[-1] = _set_tone(finals[-1], "5")  # 桌上, 地下
        elif len(word) > 1 and word[-1] in "来去" \
                and word[-2] in "上下进出回过起开":
            finals[-1] = _set_tone(finals[-1], "5")  # 上来, 下去
        elif (ge_idx >= 1 and (
                word[ge_idx - 1].isnumeric()
                or word[ge_idx - 1] in "几有两半多各整每做是")) or word == "个":
            finals[ge_idx] = _set_tone(finals[ge_idx], "5")  # 三个, 每个
        elif word in MUST_NEURAL or word[-2:] in MUST_NEURAL:
            finals[-1] = _set_tone(finals[-1], "5")

        # sub-word check: 豆腐脑 -> 豆腐(neutral) + 脑
        if len(word) >= 3:
            subs = _split_word(word)
            pieces = [finals[: len(subs[0])], finals[len(subs[0]):]]
            for k, sub in enumerate(subs):
                if (sub in MUST_NEURAL or sub[-2:] in MUST_NEURAL) \
                        and pieces[k]:
                    pieces[k][-1] = _set_tone(pieces[k][-1], "5")
            finals = pieces[0] + pieces[1]
        return finals

    def _three_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if len(word) != len(finals):
            # erhua-merged words etc.: fall back to run-based rule
            return self._three_runs(finals)
        if len(word) == 2 and _all_tone_three(finals):
            finals[0] = _set_tone(finals[0], "2")
        elif len(word) == 3:
            subs = _split_word(word)
            if _all_tone_three(finals):
                if len(subs[0]) == 2:  # 蒙古/包: 2+2 -> first two rise
                    finals[0] = _set_tone(finals[0], "2")
                    finals[1] = _set_tone(finals[1], "2")
                elif len(subs[0]) == 1:  # 纸/老虎: middle rises
                    finals[1] = _set_tone(finals[1], "2")
            else:
                pieces = [finals[: len(subs[0])], finals[len(subs[0]):]]
                for k, sub in enumerate(pieces):
                    if _all_tone_three(sub) and len(sub) == 2:
                        sub[0] = _set_tone(sub[0], "2")  # 所有/人
                    elif (
                        k == 1 and not _all_tone_three(sub) and sub
                        and _tone(sub[0]) == "3" and pieces[0]
                        and _tone(pieces[0][-1]) == "3"
                    ):
                        # boundary pair 3+3: 好/喜欢
                        pieces[0][-1] = _set_tone(pieces[0][-1], "2")
                finals = pieces[0] + pieces[1]
        elif len(word) == 4:  # idioms: 2+2
            for s in (0, 2):
                if _all_tone_three(finals[s:s + 2]):
                    finals[s] = _set_tone(finals[s], "2")
        else:
            finals = self._three_runs(finals)
        return finals

    @staticmethod
    def _three_runs(finals: List[str]) -> List[str]:
        """Run-based fallback: in each run of 3rd tones all but the last
        become 2nd."""
        n = len(finals)
        i = 0
        while i < n:
            if _tone(finals[i]) == "3":
                j = i
                while j + 1 < n and _tone(finals[j + 1]) == "3":
                    j += 1
                for k in range(i, j):
                    finals[k] = _set_tone(finals[k], "2")
                i = j + 1
            else:
                i += 1
        return finals

    def modified_tone(
        self, word: str, pos: str, finals: List[str]
    ) -> List[str]:
        # pure in (word, pos, finals) — the rule tables are static — and
        # words repeat heavily in serving text, so memoize (the result is
        # copied out: erhua merging mutates it downstream). Cleared by
        # zh_frontend.clear_frontend_caches on custom-dict load.
        key = (word, pos, tuple(finals))
        hit = _MT_CACHE.get(key)
        if hit is not None:
            return list(hit)
        finals = self._bu_sandhi(word, finals)
        finals = self._yi_sandhi(word, finals)
        finals = self._neural_sandhi(word, pos, finals)
        finals = self._three_sandhi(word, finals)
        if len(_MT_CACHE) < _MT_CACHE_MAX:
            _MT_CACHE[key] = tuple(finals)
        return finals
