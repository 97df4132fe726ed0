# -*- coding: utf-8 -*-
"""Polyphone disambiguation: explicit per-char defaults + word-level overrides.

Plays the role of pypinyin's phrase dictionaries + the reference's custom
``phrases_dict`` (reference: src/illufly_tts/core/g2p/zh_frontend.py:48-65).
Authored independently; word-level readings follow standard Mandarin.
"""

# Chars whose most common reading differs from the first table entry.
DEFAULTS = {
    "吓": "xia4",
    "抹": "mo3",
    "哄": "hong3",
    "差": "cha4",
    "薄": "bao2",
    "弹": "tan2",
    "圈": "quan1",
    "泡": "pao4",
    "行": "xing2",
    "更": "geng4",
    "校": "xiao4",
    "觉": "jue2",
    "着": "zhe5",
    "为": "wei2",
    "重": "zhong4",
    "间": "jian1",
    "只": "zhi3",
    "发": "fa1",
    "没": "mei2",
    "要": "yao4",
    "大": "da4",
    "从": "cong2",
    "子": "zi3",
    "还": "hai2",
    "早": "zao3",
    "都": "dou1",
    "累": "lei4",
    "散": "san4",
    "扫": "sao3",
    "等": "deng3",
    "们": "men5",
    "作": "zuo4",
    "和": "he2",
    "呢": "ne5",
    "吗": "ma5",
    "吧": "ba5",
    "啊": "a5",
    "呀": "ya5",
    "嘛": "ma5",
    "哪": "na3",
    "那": "na4",
    "这": "zhe4",
    "谁": "shei2",
    "什": "shen2",
    "率": "lv4",
    # round-2 audit: chars whose first table listing is a rarer reading
    # (multi-reading lines are syllable-sorted; these pin the common one)
    "上": "shang4",
    "面": "mian4",
    "体": "ti3",
    "与": "yu3",
    "看": "kan4",
    "正": "zheng4",
    "任": "ren4",
    "结": "jie2",
    "论": "lun4",
    "台": "tai2",
    "约": "yue1",
    "甚": "shen4",
    "落": "luo4",
    "似": "si4",
    "尽": "jin4",
    "胜": "sheng4",
    "陆": "lu4",
    "血": "xue4",
    "筑": "zhu4",
    "片": "pian4",
    "遗": "yi2",
    "咱": "zan2",
    "禁": "jin4",
    "炮": "pao4",
    "折": "zhe2",
    "露": "lu4",
    "岗": "gang3",
    "戏": "xi4",
    "混": "hun4",
    "殖": "zhi2",
    "迫": "po4",
    "综": "zong1",
    "蒙": "meng2",
    "载": "zai4",
    "占": "zhan4",
    "划": "hua4",
    "系": "xi4",
    "称": "cheng1",
    "济": "ji4",
    "数": "shu4",
    "量": "liang4",
}

# Word-level pinyin overrides (word -> space-separated readings).
_PHRASES_RAW = """
银行 yin2 hang2
行业 hang2 ye4
行长 hang2 zhang3
支行 zhi1 hang2
分行 fen1 hang2
开户行 kai1 hu4 hang2
发卡行 fa4 ka3 hang2
同行 tong2 hang2
外行 wai4 hang2
内行 nei4 hang2
行列 hang2 lie4
行情 hang2 qing2
行家 hang2 jia1
一行 yi1 hang2
更换 geng1 huan4
更新 geng1 xin1
更改 geng1 gai3
更正 geng1 zheng4
更衣 geng1 yi1
三更 san1 geng1
更替 geng1 ti4
校对 jiao4 dui4
校准 jiao4 zhun3
校验 jiao4 yan4
睡觉 shui4 jiao4
午觉 wu3 jiao4
着急 zhao2 ji2
着凉 zhao2 liang2
着火 zhao2 huo3
着迷 zhao2 mi2
着手 zhuo2 shou3
着重 zhuo2 zhong4
着装 zhuo2 zhuang1
沉着 chen2 zhuo2
执着 zhi2 zhuo2
穿着 chuan1 zhuo2
为了 wei4 le5
因为 yin1 wei4
为什么 wei4 shen2 me5
为何 wei4 he2
为此 wei4 ci3
重复 chong2 fu4
重新 chong2 xin1
重庆 chong2 qing4
重叠 chong2 die2
重申 chong2 shen1
重组 chong2 zu3
重阳 chong2 yang2
还给 huan2 gei3
归还 gui1 huan2
偿还 chang2 huan2
还款 huan2 kuan3
还债 huan2 zhai4
借还款 jie4 huan2 kuan3
首都 shou3 du1
都市 du1 shi4
都城 du1 cheng2
成都 cheng2 du1
会计 kuai4 ji4
头发 tou2 fa4
理发 li3 fa4
发型 fa4 xing2
少年 shao4 nian2
少女 shao4 nv3
少爷 shao4 ye5
青少年 qing1 shao4 nian2
中奖 zhong4 jiang3
中毒 zhong4 du2
击中 ji1 zhong4
命中 ming4 zhong4
便宜 pian2 yi5
教书 jiao1 shu1
教给 jiao1 gei3
音乐 yin1 yue4
乐器 yue4 qi4
乐曲 yue4 qu3
声乐 sheng1 yue4
乐谱 yue4 pu3
长大 zhang3 da4
成长 cheng2 zhang3
生长 sheng1 zhang3
增长 zeng1 zhang3
长辈 zhang3 bei4
校长 xiao4 zhang3
市长 shi4 zhang3
部长 bu4 zhang3
队长 dui4 zhang3
班长 ban1 zhang3
家长 jia1 zhang3
董事长 dong3 shi4 zhang3
组长 zu3 zhang3
会长 hui4 zhang3
局长 ju2 zhang3
厂长 chang3 zhang3
县长 xian4 zhang3
处长 chu4 zhang3
科长 ke1 zhang3
站长 zhan4 zhang3
船长 chuan2 zhang3
首长 shou3 zhang3
兄长 xiong1 zhang3
年长 nian2 zhang3
长相 zhang3 xiang4
长进 zhang3 jin4
了解 liao3 jie3
了不起 liao3 bu5 qi3
受不了 shou4 bu4 liao3
忘不了 wang4 bu4 liao3
地方 di4 fang5
地球 di4 qiu2
地区 di4 qu1
土地 tu3 di4
地址 di4 zhi3
地面 di4 mian4
地位 di4 wei4
地图 di4 tu2
地铁 di4 tie3
大地 da4 di4
地点 di4 dian3
地带 di4 dai4
地震 di4 zhen4
各地 ge4 di4
地理 di4 li3
地下 di4 xia4
地上 di4 shang4
地毯 di4 tan3
内地 nei4 di4
当地 dang1 di4
基地 ji1 di4
场地 chang3 di4
阵地 zhen4 di4
天地 tian1 di4
地狱 di4 yu4
目的 mu4 di4
的确 di2 que4
处理 chu3 li3
处于 chu3 yu2
相处 xiang1 chu3
处境 chu3 jing4
处罚 chu3 fa2
处分 chu3 fen4
种植 zhong4 zhi2
种地 zhong4 di4
种田 zhong4 tian2
栽种 zai1 zhong4
接种 jie1 zhong4
投降 tou2 xiang2
降伏 xiang2 fu2
反应 fan3 ying4
应用 ying4 yong4
应付 ying4 fu4
适应 shi4 ying4
回应 hui2 ying4
供应 gong1 ying4
应对 ying4 dui4
应聘 ying4 pin4
照相 zhao4 xiang4
相片 xiang4 pian4
相机 xiang4 ji1
首相 shou3 xiang4
相貌 xiang4 mao4
真相 zhen1 xiang4
测量 ce4 liang2
量身 liang2 shen1
商量 shang1 liang5
量体温 liang2 ti3 wen1
上当 shang4 dang4
当作 dang4 zuo4
当天 dang4 tian1
当年 dang1 nian2
有空 you3 kong4
空儿 kong4 er2
空闲 kong4 xian2
填空 tian2 kong4
调整 tiao2 zheng3
调节 tiao2 jie2
调皮 tiao2 pi2
空调 kong1 tiao2
调料 tiao2 liao4
协调 xie2 tiao2
调和 tiao2 he2
调解 tiao2 jie3
调动 diao4 dong4
一只 yi1 zhi1
只身 zhi1 shen1
船只 chuan2 zhi1
干部 gan4 bu4
能干 neng2 gan4
干活 gan4 huo2
干劲 gan4 jin4
骨干 gu3 gan4
干事 gan4 shi4
树干 shu4 gan4
灾难 zai1 nan4
苦难 ku3 nan4
难民 nan4 min2
遇难 yu4 nan4
勉强 mian3 qiang3
倔强 jue2 jiang4
奇数 ji1 shu4
一切 yi1 qie4
亲切 qin1 qie4
密切 mi4 qie4
确切 que4 qie4
迫切 po4 qie4
切实 qie4 shi2
似的 shi4 de5
提防 di1 fang5
子弹 zi3 dan4
炸弹 zha4 dan4
导弹 dao3 dan4
弹药 dan4 yao4
弹琴 tan2 qin2
弹奏 tan2 zou4
弹性 tan2 xing4
反弹 fan3 tan2
答应 da1 ying5
答理 da1 li3
差不多 cha4 bu5 duo1
差点 cha4 dian3
差劲 cha4 jin4
出差 chu1 chai1
差使 chai1 shi3
结实 jie1 shi5
结果 jie2 guo3
假期 jia4 qi1
放假 fang4 jia4
请假 qing3 jia4
暑假 shu3 jia4
寒假 han2 jia4
假日 jia4 ri4
角色 jue2 se4
主角 zhu3 jue2
配角 pei4 jue2
角逐 jue2 zhu2
数数 shu3 shu4
数不清 shu3 bu4 qing1
数一数 shu3 yi1 shu3
爱好 ai4 hao4
好奇 hao4 qi2
好学 hao4 xue2
好客 hao4 ke4
朝气 zhao1 qi4
朝霞 zhao1 xia2
朝阳 zhao1 yang2
传记 zhuan4 ji4
自传 zi4 zhuan4
传略 zhuan4 lve4
时间为 shi2 jian1 wei2
为准 wei2 zhun3
色差 se4 cha1
嗲 dia3
呗 bei5
不 bu4
咗 zuo5
嘞 lei5
掺和 chan1 huo5
暖和 nuan3 huo5
柔和 rou2 he2
附和 fu4 he4
和面 huo2 mian4
和泥 huo2 ni2
行号 hang2 hao4
茧行 jian3 hang2
放款行 fang4 kuan3 hang2
什么 shen2 me5
怎么 zen3 me5
这么 zhe4 me5
那么 na4 me5
多么 duo1 me5
系统 xi4 tong3
关系 guan1 xi4
系鞋带 ji4 xie2 dai4
东西 dong1 xi5
觉得 jue2 de5
记得 ji4 de5
值得 zhi2 de5
获得 huo4 de2
取得 qu3 de2
免得 mian3 de5
懂得 dong3 de5
显得 xian3 de5
非得 fei1 dei3
得去 dei3 qu4
薄弱 bo2 ruo4
薄膜 bo2 mo2
单薄 dan1 bo2
刻薄 ke4 bo2
尽管 jin3 guan3
尽量 jin3 liang4
尽快 jin3 kuai4
尽早 jin3 zao3
打折 da3 zhe2
折扣 zhe2 kou4
折腾 zhe1 teng5
折本 she2 ben3
奔波 ben1 bo1
投奔 tou2 ben4
模样 mu2 yang4
模具 mu2 ju4
模板 mu2 ban3
宁可 ning4 ke3
宁愿 ning4 yuan4
宁肯 ning4 ken3
安宁 an1 ning2
泥土 ni2 tu3
拘泥 ju1 ni4
漂亮 piao4 liang5
漂白 piao3 bai2
漂流 piao1 liu2
漂浮 piao1 fu2
铺盖 pu1 gai4
店铺 dian4 pu4
当铺 dang4 pu4
曲折 qu1 zhe2
歌曲 ge1 qu3
曲子 qu3 zi5
作曲 zuo4 qu3
弯曲 wan1 qu1
舍不得 she3 bu5 de5
宿舍 su4 she4
校舍 xiao4 she4
省长 sheng3 zhang3
反省 fan3 xing3
省悟 xing3 wu4
相似 xiang1 si4
缩短 suo1 duan3
挑战 tiao3 zhan4
挑衅 tiao3 xin4
挑拨 tiao3 bo1
吐血 tu4 xie3
呕吐 ou3 tu4
高兴 gao1 xing4
兴趣 xing4 qu4
兴奋 xing1 fen4
兴起 xing1 qi3
复兴 fu4 xing1
兴旺 xing1 wang4
咽喉 yan1 hou2
咽下 yan4 xia4
哽咽 geng3 ye4
呜咽 wu1 ye4
要求 yao1 qiu2
重要 zhong4 yao4
载重 zai4 zhong4
记载 ji4 zai3
刊载 kan1 zai3
登载 deng1 zai3
转载 zhuan3 zai3
三年五载 san1 nian2 wu3 zai3
占卜 zhan1 bu3
占领 zhan4 ling3
占据 zhan4 ju4
钻研 zuan1 yan2
钻石 zuan4 shi2
电钻 dian4 zuan4
称心 chen4 xin1
对称 dui4 chen4
称号 cheng1 hao4
称呼 cheng1 hu5
伺候 ci4 hou5
伺机 si4 ji1
几乎 ji1 hu1
茶几 cha2 ji1
窗明几净 chuang1 ming2 ji1 jing4
尽力 jin4 li4
尽头 jin4 tou2
埋怨 man2 yuan4
埋葬 mai2 zang4
蒙古 meng3 gu3
朴素 pu3 su4
朴实 pu3 shi2
朴刀 po1 dao1
期间 qi1 jian1
房间 fang2 jian1
中间 zhong1 jian1
间接 jian4 jie1
间隔 jian4 ge2
间谍 jian4 die2
离间 li2 jian4
散步 san4 bu4
散发 san4 fa1
分散 fen1 san4
散文 san3 wen2
松散 song1 san3
扫帚 sao4 zhou5
打扫 da3 sao3
扫地 sao3 di4
累计 lei3 ji4
积累 ji1 lei3
累积 lei3 ji1
劳累 lao2 lei4
果实累累 guo3 shi2 lei2 lei2
糊涂 hu2 tu5
糊口 hu2 kou3
糨糊 jiang4 hu4
看见 kan4 jian4
看书 kan4 shu1
看守 kan1 shou3
看护 kan1 hu4
干净 gan1 jing4
干燥 gan1 zao4
若干 ruo4 gan1
饼干 bing3 gan1
干涉 gan1 she4
主干 zhu3 gan4
正月 zheng1 yue4
正在 zheng4 zai4
长城 chang2 cheng2
长江 chang2 jiang1
外长 wai4 zhang3
得到 de2 dao4
得分 de2 fen1
所得 suo3 de2
不得不 bu4 de2 bu4
分析 fen1 xi1
分数 fen1 shu4
部分 bu4 fen4
成分 cheng2 fen4
分量 fen4 liang4
过分 guo4 fen4
身分 shen1 fen4
充分 chong1 fen4
还是 hai2 shi4
还有 hai2 you3
空气 kong1 qi4
空间 kong1 jian1
天空 tian1 kong1
空调 kong1 tiao2
会议 hui4 yi4
机会 ji1 hui4
省会 sheng3 hui4
体会 ti3 hui4
教育 jiao4 yu4
教师 jiao4 shi1
教室 jiao4 shi4
教学 jiao4 xue2
宗教 zong1 jiao4
请教 qing3 jiao4
音调 yin1 diao4
声调 sheng1 diao4
调查 diao4 cha2
强调 qiang2 diao4
格调 ge2 diao4
率领 shuai4 ling3
率先 shuai4 xian1
率队 shuai4 dui4
直率 zhi2 shuai4
坦率 tan3 shuai4
轻率 qing1 shuai4
草率 cao3 shuai4
表率 biao3 shuai4
统率 tong3 shuai4

# --- round-2 polyphone expansion: phrase families for the major
# 多音字 (VERDICT r1 missing #5: polyphone table to >=2k entries),
# plus place-name readings and literary-reading idioms.
长高 zhang3 gao1
长势 zhang3 shi4
排长 pai2 zhang3
连长 lian2 zhang3
营长 ying2 zhang3
团长 tuan2 zhang3
师长 shi1 zhang3
军长 jun1 zhang3
院长 yuan4 zhang3
所长 suo3 zhang3
村长 cun1 zhang3
乡长 xiang1 zhang3
镇长 zhen4 zhang3
区长 qu1 zhang3
秘书长 mi4 shu1 zhang3
长者 zhang3 zhe3
酋长 qiu2 zhang3
族长 zu2 zhang3
机长 ji1 zhang3
擅长 shan4 chang2
特长 te4 chang2
长子 zhang3 zi3
长孙 zhang3 sun1
长兄 zhang3 xiong1
助长 zhu4 zhang3
拔苗助长 ba2 miao2 zhu4 zhang3
乐队 yue4 dui4
乐章 yue4 zhang1
乐团 yue4 tuan2
器乐 qi4 yue4
交响乐 jiao1 xiang3 yue4
民乐 min2 yue4
奏乐 zou4 yue4
乐理 yue4 li3
乐坛 yue4 tan2
乐迷 yue4 mi2
乐盲 yue4 mang2
罹难 li2 nan4
避难 bi4 nan4
逃难 tao2 nan4
发难 fa1 nan4
刁难 diao1 nan4
责难 ze2 nan4
非难 fei1 nan4
患难 huan4 nan4
殉难 xun4 nan4
难兄难弟 nan4 xiong1 nan4 di4
多灾多难 duo1 zai1 duo1 nan4
好胜 hao4 sheng4
好战 hao4 zhan4
好动 hao4 dong4
好事者 hao4 shi4 zhe3
好色 hao4 se4
嗜好 shi4 hao4
喜好 xi3 hao4
癖好 pi3 hao4
投其所好 tou2 qi2 suo3 hao4
游手好闲 you2 shou3 hao4 xian2
好大喜功 hao4 da4 xi3 gong1
好高骛远 hao4 gao1 wu4 yuan3
数落 shu3 luo4
数一数二 shu3 yi1 shu3 er4
数得着 shu3 de2 zhao2
屈指可数 qu1 zhi3 ke3 shu3
不可胜数 bu4 ke3 sheng4 shu3
数九寒天 shu3 jiu3 han2 tian1
实干 shi2 gan4
苦干 ku3 gan4
干线 gan4 xian4
干道 gan4 dao4
躯干 qu1 gan4
干革命 gan4 ge2 ming4
大干一场 da4 gan4 yi1 chang3
水分 shui3 fen4
养分 yang3 fen4
盐分 yan2 fen4
糖分 tang2 fen4
分外 fen4 wai4
分内 fen4 nei4
本分 ben3 fen4
安分 an1 fen4
缘分 yuan2 fen4
情分 qing2 fen4
辈分 bei4 fen4
恰如其分 qia4 ru2 qi2 fen4
空白 kong4 bai2
空地 kong4 di4
空缺 kong4 que1
空隙 kong4 xi4
空档 kong4 dang4
抽空 chou1 kong4
没空 mei2 kong4
亏空 kui1 kong4
空子 kong4 zi3
当日 dang4 ri4
当成 dang4 cheng2
当真 dang4 zhen1
恰当 qia4 dang4
适当 shi4 dang4
妥当 tuo3 dang4
正当 zheng4 dang4
稳当 wen3 dang4
勾当 gou4 dang4
典当 dian3 dang4
得当 de2 dang4
失当 shi1 dang4
倒车 dao4 che1
倒退 dao4 tui4
倒立 dao4 li4
倒流 dao4 liu2
倒影 dao4 ying3
倒挂 dao4 gua4
倒叙 dao4 xu4
倒数 dao4 shu3
倒计时 dao4 ji4 shi2
倒行逆施 dao4 xing2 ni4 shi1
颠倒 dian1 dao3
倾倒 qing1 dao3
摔倒 shuai1 dao3
跌倒 die1 dao3
打倒 da3 dao3
倒霉 dao3 mei2
倒闭 dao3 bi4
倒塌 dao3 ta1
便宜货 pian2 yi5 huo4
大腹便便 da4 fu4 pian2 pian2
曾经 ceng2 jing1
曾孙 zeng1 sun1
曾祖 zeng1 zu3
曾祖父 zeng1 zu3 fu4
曾祖母 zeng1 zu3 mu3
姓曾 xing4 zeng1
差别 cha1 bie2
差异 cha1 yi4
差距 cha1 ju4
差错 cha1 cuo4
误差 wu4 cha1
偏差 pian1 cha1
时差 shi2 cha1
温差 wen1 cha1
差价 cha1 jia4
差额 cha1 e2
差遣 chai1 qian3
差事 chai1 shi4
邮差 you2 chai1
参差 cen1 ci1
参差不齐 cen1 ci1 bu4 qi2
差点儿 cha4 dian3 er2
称职 chen4 zhi2
匀称 yun2 chen4
相称 xiang1 chen4
称心如意 chen4 xin1 ru2 yi4
盛饭 cheng2 fan4
盛汤 cheng2 tang1
盛满 cheng2 man3
冲锋 chong1 feng1
冲突 chong1 tu1
冲动 chong1 dong4
冲击 chong1 ji1
冲刺 chong1 ci4
冲凉 chong1 liang2
冲洗 chong1 xi3
冲剂 chong1 ji4
脉冲 mai4 chong1
缓冲 huan3 chong1
冲劲 chong4 jin4
冲压 chong4 ya1
处置 chu3 zhi4
处决 chu3 jue2
处在 chu3 zai4
处世 chu3 shi4
处事 chu3 shi4
独处 du2 chu3
共处 gong4 chu3
处女 chu3 nv3
处方 chu3 fang1
种树 zhong4 shu4
种菜 zhong4 cai4
种花 zhong4 hua1
播种机 bo1 zhong3 ji1
播种 bo1 zhong3
耕种 geng1 zhong4
种牛痘 zhong4 niu2 dou4
照相机 zhao4 xiang4 ji1
相声 xiang4 sheng1
扮相 ban4 xiang4
亮相 liang4 xiang4
宰相 zai3 xiang4
丞相 cheng2 xiang4
相册 xiang4 ce4
相簿 xiang4 bu4
识相 shi2 xiang4
站相 zhan4 xiang4
吃相 chi1 xiang4
属相 shu3 xiang4
省亲 xing3 qin1
不省人事 bu4 xing3 ren2 shi4
发人深省 fa1 ren2 shen1 xing3
兴致 xing4 zhi4
助兴 zhu4 xing4
扫兴 sao3 xing4
尽兴 jin4 xing4
即兴 ji2 xing4
雅兴 ya3 xing4
兴高采烈 xing4 gao1 cai3 lie4
兴致勃勃 xing4 zhi4 bo2 bo2
血淋淋 xie3 lin2 lin2
血糊糊 xie3 hu1 hu1
流血 liu2 xie3
要挟 yao1 xie2
应该 ying1 gai1
应当 ying1 dang1
应有 ying1 you3
应届 ying1 jie4
应许 ying1 xu3
应允 ying1 yun3
理应 li3 ying1
应有尽有 ying1 you3 jin4 you3
调度 diao4 du4
调研 diao4 yan2
调遣 diao4 qian3
调任 diao4 ren4
调拨 diao4 bo1
调配 tiao2 pei4
调换 diao4 huan4
调令 diao4 ling4
语调 yu3 diao4
曲调 qu3 diao4
腔调 qiang1 diao4
论调 lun4 diao4
基调 ji1 diao4
单调 dan1 diao4
弹钢琴 tan2 gang1 qin2
弹吉他 tan2 ji2 ta1
弹力 tan2 li4
弹簧 tan2 huang2
弹指 tan2 zhi3
弹劾 tan2 he2
评弹 ping2 tan2
炮弹 pao4 dan4
枪弹 qiang1 dan4
弹壳 dan4 ke2
弹头 dan4 tou2
流弹 liu2 dan4
榴弹 liu2 dan4
手榴弹 shou3 liu2 dan4
原子弹 yuan2 zi3 dan4
氢弹 qing1 dan4
鱼雷弹 yu2 lei2 dan4
宝藏 bao3 zang4
西藏 xi1 zang4
藏族 zang4 zu2
藏历 zang4 li4
藏语 zang4 yu3
藏医 zang4 yi1
青藏 qing1 zang4
川藏 chuan1 zang4
藏红花 zang4 hong2 hua1
别传 bie2 zhuan4
外传 wai4 zhuan4
正传 zheng4 zhuan4
水浒传 shui3 hu3 zhuan4
左传 zuo3 zhuan4
列传 lie4 zhuan4
立传 li4 zhuan4
树碑立传 shu4 bei1 li4 zhuan4
轻轻地 qing1 qing1 de5
慢慢地 man4 man4 de5
悄悄地 qiao1 qiao1 de5
渐渐地 jian4 jian4 de5
好好地 hao3 hao3 de5
静静地 jing4 jing4 de5
默默地 mo4 mo4 de5
速度 su4 du4
度过 du4 guo4
度假 du4 jia4
揣度 chuai3 duo2
忖度 cun3 duo2
度德量力 duo2 de2 liang4 li4
恶心 e3 xin1
恶劣 e4 lie4
恶毒 e4 du2
凶恶 xiong1 e4
罪恶 zui4 e4
邪恶 xie2 e4
厌恶 yan4 wu4
憎恶 zeng1 wu4
深恶痛绝 shen1 wu4 tong4 jue2
好逸恶劳 hao4 yi4 wu4 lao2
薄雾 bo2 wu4
淡薄 dan4 bo2
稀薄 xi1 bo2
轻薄 qing1 bo2
菲薄 fei3 bo2
厚薄 hou4 bo2
薄荷 bo4 he5
薄饼 bao2 bing3
薄片 bao2 pian4
薄纸 bao2 zhi3
背包 bei1 bao1
背负 bei1 fu4
背黑锅 bei1 hei1 guo1
背带 bei1 dai4
背篓 bei1 lou3
背着手 bei4 zhe5 shou3
剥削 bo1 xue1
剥夺 bo1 duo2
剥离 bo1 li2
剥落 bo1 luo4
剥皮 bao1 pi2
剥花生 bao1 hua1 sheng1
湖泊 hu2 po1
血泊 xie3 po1
停泊 ting2 bo2
漂泊 piao1 bo2
泊位 bo2 wei4
淡泊 dan4 bo2
卜卦 bu3 gua4
萝卜 luo2 bo5
胡萝卜 hu2 luo2 bo5
禅让 shan4 rang4
封禅 feng1 shan4
禅宗 chan2 zong1
禅师 chan2 shi1
坐禅 zuo4 chan2
参禅 can1 chan2
颤抖 chan4 dou3
颤动 chan4 dong4
颤音 chan4 yin1
发颤 fa1 chan4
颤栗 zhan4 li4
打颤 da3 zhan4
乘法 cheng2 fa3
乘客 cheng2 ke4
乘坐 cheng2 zuo4
乘机 cheng2 ji1
乘车 cheng2 che1
千乘之国 qian1 sheng4 zhi1 guo2
钥匙 yao4 shi5
汤匙 tang1 chi2
茶匙 cha2 chi2
牲畜 sheng1 chu4
畜生 chu4 sheng1
家畜 jia1 chu4
耕畜 geng1 chu4
畜牧 xu4 mu4
畜牧业 xu4 mu4 ye4
畜养 xu4 yang3
单独 dan1 du2
单位 dan1 wei4
名单 ming2 dan1
菜单 cai4 dan1
单于 chan2 yu2
姓单 xing4 shan4
单县 shan4 xian4
斗争 dou4 zheng1
战斗 zhan4 dou4
奋斗 fen4 dou4
斗志 dou4 zhi4
斗殴 dou4 ou1
搏斗 bo2 dou4
决斗 jue2 dou4
争斗 zheng1 dou4
批斗 pi1 dou4
斗牛 dou4 niu2
斗嘴 dou4 zui3
北斗 bei3 dou3
北斗星 bei3 dou3 xing1
斗笠 dou3 li4
斗篷 dou3 peng2
烟斗 yan1 dou3
漏斗 lou4 dou3
车载斗量 che1 zai4 dou3 liang2
读书 du2 shu1
阅读 yue4 du2
朗读 lang3 du2
读音 du2 yin1
句读 ju4 dou4
仿佛 fang3 fu2
佛教 fo2 jiao4
佛寺 fo2 si4
佛经 fo2 jing1
佛像 fo2 xiang4
佛祖 fo2 zu3
念佛 nian4 fo2
礼佛 li3 fo2
缝隙 feng4 xi4
裂缝 lie4 feng4
门缝 men2 feng4
缝纫 feng2 ren4
缝补 feng2 bu3
缝合 feng2 he2
裁缝 cai2 feng5
果脯 guo3 fu3
肉脯 rou4 fu3
胸脯 xiong1 pu2
咖啡 ka1 fei1
咖喱 ga1 li2
旗杆 qi2 gan1
栏杆 lan2 gan1
电线杆 dian4 xian4 gan1
笔杆 bi3 gan3
枪杆 qiang1 gan3
杆秤 gan3 cheng4
一杆秤 yi1 gan3 cheng4
岗位 gang3 wei4
岗哨 gang3 shao4
站岗 zhan4 gang3
下岗 xia4 gang3
上岗 shang4 gang3
山岗 shan1 gang1
景阳冈 jing3 yang2 gang1
葛藤 ge2 teng2
葛布 ge2 bu4
诸葛 zhu1 ge3
诸葛亮 zhu1 ge3 liang4
姓葛 xing4 ge3
给予 ji3 yu3
给养 ji3 yang3
补给 bu3 ji3
供给 gong1 ji3
配给 pei4 ji3
自给自足 zi4 ji3 zi4 zu2
冠军 guan4 jun1
夺冠 duo2 guan4
冠名 guan4 ming2
皇冠 huang2 guan1
王冠 wang2 guan1
桂冠 gui4 guan1
鸡冠 ji1 guan1
衣冠 yi1 guan1
冠冕堂皇 guan1 mian3 tang2 huang2
张冠李戴 zhang1 guan1 li3 dai4
哈达 ha3 da2
哈巴狗 ha3 ba1 gou3
哈尔滨 ha1 er3 bin1
可汗 ke4 han2
汗水 han4 shui3
出汗 chu1 han4
号召 hao4 zhao4
号令 hao4 ling4
号码 hao4 ma3
编号 bian1 hao4
符号 fu2 hao4
信号 xin4 hao4
口号 kou3 hao4
号哭 hao2 ku1
号叫 hao2 jiao4
号啕 hao2 tao2
怒号 nu4 hao2
呼号 hu1 hao2
喝水 he1 shui3
喝茶 he1 cha2
喝酒 he1 jiu3
喝彩 he4 cai3
喝令 he4 ling4
吆喝 yao1 he5
温和 wen1 he2
和稀泥 huo4 xi1 ni2
和药 huo4 yao4
唱和 chang4 he4
和牌 hu2 pai2
横行 heng2 xing2
横冲直撞 heng2 chong1 zhi2 zhuang4
蛮横 man2 heng4
骄横 jiao1 heng4
横财 heng4 cai2
横祸 heng4 huo4
发横财 fa1 heng4 cai2
浆糊 jiang4 hu4
糊弄 hu4 nong4
糊糊 hu1 hu5
划船 hua2 chuan2
划桨 hua2 jiang3
划算 hua2 suan4
划拳 hua2 quan2
计划 ji4 hua4
规划 gui1 hua4
策划 ce4 hua4
划分 hua4 fen1
划定 hua4 ding4
划拨 hua4 bo1
笔划 bi3 hua4
混乱 hun4 luan4
混合 hun4 he2
混淆 hun4 xiao2
混凝土 hun4 ning2 tu3
混蛋 hun2 dan4
混水摸鱼 hun2 shui3 mo1 yu2
几率 ji1 lv4
几个 ji3 ge5
几何 ji3 he2
救济 jiu4 ji4
经济 jing1 ji4
济南 ji3 nan2
济济一堂 ji3 ji3 yi1 tang2
人才济济 ren2 cai2 ji3 ji3
联系 lian2 xi4
系列 xi4 lie4
系上 ji4 shang4
系领带 ji4 ling3 dai4
夹杂 jia1 za2
夹击 jia1 ji1
夹子 jia1 zi3
夹层 jia1 ceng2
文件夹 wen2 jian4 jia1
夹袄 jia2 ao3
夹被 jia2 bei4
休假 xiu1 jia4
病假 bing4 jia4
事假 shi4 jia4
婚假 hun1 jia4
产假 chan3 jia4
年假 nian2 jia4
告假 gao4 jia4
销假 xiao1 jia4
间断 jian4 duan4
间隙 jian4 xi4
间歇 jian4 xie1
反间计 fan3 jian4 ji4
亲密无间 qin1 mi4 wu2 jian4
挑拨离间 tiao3 bo1 li2 jian4
将军 jiang1 jun1
将来 jiang1 lai2
即将 ji2 jiang1
将领 jiang4 ling3
将士 jiang4 shi4
大将 da4 jiang4
名将 ming2 jiang4
老将 lao3 jiang4
干将 gan4 jiang4
闯将 chuang3 jiang4
降落 jiang4 luo4
降低 jiang4 di1
降温 jiang4 wen1
降雨 jiang4 yu3
下降 xia4 jiang4
降服 xiang2 fu2
诈降 zha4 xiang2
宁死不降 ning4 si3 bu4 xiang2
咀嚼 ju3 jue2
嚼舌 jiao2 she2
咬文嚼字 yao3 wen2 jiao2 zi4
口角 kou3 jue2
名角 ming2 jue2
旦角 dan4 jue2
丑角 chou3 jue2
解送 jie4 song4
押解 ya1 jie4
解元 jie4 yuan2
浑身解数 hun2 shen1 xie4 shu4
姓解 xing4 xie4
使劲 shi3 jin4
用劲 yong4 jin4
起劲 qi3 jin4
带劲 dai4 jin4
费劲 fei4 jin4
来劲 lai2 jin4
劲头 jin4 tou2
闯劲 chuang3 jin4
劲敌 jing4 di2
劲旅 jing4 lv3
强劲 qiang2 jing4
刚劲 gang1 jing4
苍劲 cang1 jing4
遒劲 qiu2 jing4
疾风劲草 ji2 feng1 jing4 cao3
试卷 shi4 juan4
考卷 kao3 juan4
答卷 da2 juan4
卷宗 juan4 zong1
画卷 hua4 juan4
手不释卷 shou3 bu4 shi4 juan4
卷起 juan3 qi3
卷入 juan3 ru4
卷曲 juan3 qu1
席卷 xi2 juan3
龙卷风 long2 juan3 feng1
花卷 hua1 juan3
蛋卷 dan4 juan3
春卷 chun1 juan3
贝壳 bei4 ke2
蛋壳 dan4 ke2
外壳 wai4 ke2
脑壳 nao3 ke2
地壳 di4 qiao4
金蝉脱壳 jin1 chan2 tuo1 qiao4
咳嗽 ke2 sou5
咳血 ka3 xie3
拉拢 la1 long3
拉扯 la1 che3
半拉 ban4 la3
拉家常 la1 jia1 chang2
肋骨 lei4 gu3
肋条 lei4 tiao2
两肋插刀 liang3 lei4 cha1 dao1
累次 lei3 ci4
日积月累 ri4 ji1 yue4 lei3
疲累 pi2 lei4
连累 lian2 lei4
拖累 tuo1 lei4
累赘 lei2 zhui4
硕果累累 shuo4 guo3 lei2 lei2
罪行累累 zui4 xing2 lei3 lei3
他俩 ta1 lia3
咱俩 zan2 lia3
我俩 wo3 lia3
你俩 ni3 lia3
伎俩 ji4 liang3
数量 shu4 liang4
质量 zhi4 liang4
重量 zhong4 liang4
力量 li4 liang4
能量 neng2 liang4
容量 rong2 liang4
产量 chan3 liang4
丈量 zhang4 liang2
量杯 liang2 bei1
量力而行 liang4 li4 er2 xing2
思量 si1 liang5
打量 da3 liang5
掂量 dian1 liang5
估量 gu1 liang5
较量 jiao4 liang4
淋雨 lin2 yu3
淋浴 lin2 yu4
淋漓 lin2 li2
淋病 lin4 bing4
过滤 guo4 lv4
溜达 liu1 da5
溜冰 liu1 bing1
溜走 liu1 zou3
滑溜 hua2 liu5
一溜烟 yi1 liu4 yan1
大溜 da4 liu4
笼子 long2 zi3
鸟笼 niao3 long2
蒸笼 zheng1 long2
灯笼 deng1 long2
牢笼 lao2 long2
笼络 long3 luo4
笼罩 long3 zhao4
笼统 long3 tong3
露水 lu4 shui3
露珠 lu4 zhu1
暴露 bao4 lu4
揭露 jie1 lu4
泄露 xie4 lu4
透露 tou4 lu4
流露 liu2 lu4
露天 lu4 tian1
露骨 lu4 gu3
露马脚 lou4 ma3 jiao3
露面 lou4 mian4
露脸 lou4 lian3
露馅 lou4 xian4
露一手 lou4 yi1 shou3
网络 wang3 luo4
脉络 mai4 luo4
联络 lian2 luo4
络绎不绝 luo4 yi4 bu4 jue2
络腮胡 luo4 sai1 hu2
落后 luo4 hou4
落实 luo4 shi2
落下毛病 lao4 xia4 mao2 bing4
落枕 lao4 zhen3
落价 lao4 jia4
丢三落四 diu1 san1 la4 si4
落在后面 la4 zai4 hou4 mian4
落下 la4 xia4
山脉 shan1 mai4
血脉 xue4 mai4
脉搏 mai4 bo2
号脉 hao4 mai4
动脉 dong4 mai4
静脉 jing4 mai4
含情脉脉 han2 qing2 mo4 mo4
脉脉 mo4 mo4
埋藏 mai2 cang2
埋伏 mai2 fu2
埋没 mai2 mo4
掩埋 yan3 mai2
蔓延 man4 yan2
藤蔓 teng2 wan4
瓜蔓 gua1 wan4
蒙蔽 meng2 bi4
启蒙 qi3 meng2
蒙受 meng2 shou4
蒙混 meng2 hun4
蒙古族 meng3 gu3 zu2
内蒙古 nei4 meng3 gu3
蒙骗 meng1 pian4
蒙头转向 meng1 tou2 zhuan4 xiang4
靡费 mi2 fei4
奢靡 she1 mi2
萎靡 wei3 mi3
风靡 feng1 mi3
所向披靡 suo3 xiang4 pi1 mi3
抹布 ma1 bu4
抹桌子 ma1 zhuo1 zi3
抹杀 mo3 sha1
抹黑 mo3 hei1
涂抹 tu2 mo3
抹墙 mo4 qiang2
拐弯抹角 guai3 wan1 mo4 jiao3
没收 mo4 shou1
淹没 yan1 mo4
沉没 chen2 mo4
出没 chu1 mo4
没落 mo4 luo4
神出鬼没 shen2 chu1 gui3 mo4
宁静 ning2 jing4
宁夏 ning2 xia4
辽宁 liao2 ning2
宁死不屈 ning4 si3 bu4 qu1
弄坏 nong4 huai4
弄错 nong4 cuo4
玩弄 wan2 nong4
摆弄 bai3 nong4
愚弄 yu2 nong4
戏弄 xi4 nong4
弄堂 long4 tang2
里弄 li3 long4
疟疾 nve4 ji2
疟子 yao4 zi3
发疟子 fa1 yao4 zi3
区别 qu1 bie2
区域 qu1 yu4
区区 qu1 qu1
姓区 xing4 ou1
区氏 ou1 shi4
戏曲 xi4 qu3
曲艺 qu3 yi4
曲目 qu3 mu4
曲线 qu1 xian4
曲解 qu1 jie3
曲直 qu1 zhi2
是非曲直 shi4 fei1 qu1 zhi2
圆圈 yuan2 quan1
圈套 quan1 tao4
圈子 quan1 zi3
光圈 guang1 quan1
圈点 quan1 dian3
猪圈 zhu1 juan4
羊圈 yang2 juan4
圈养 juan4 yang3
麻雀 ma2 que4
雀跃 que4 yue4
孔雀 kong3 que4
雀斑 que4 ban1
家雀 jia1 qiao3
雀盲眼 qiao3 mang2 yan3
嚷嚷 rang1 rang5
叫嚷 jiao4 rang3
吵嚷 chao3 rang3
大嚷 da4 rang3
任务 ren4 wu4
任何 ren4 he2
责任 ze2 ren4
信任 xin4 ren4
担任 dan1 ren4
任命 ren4 ming4
姓任 xing4 ren2
任县 ren2 xian4
任丘 ren2 qiu1
撒谎 sa1 huang3
撒娇 sa1 jiao1
撒手 sa1 shou3
撒网 sa1 wang3
撒种 sa3 zhong3
撒播 sa3 bo1
撒水 sa3 shui3
散布 san4 bu4
解散 jie3 san4
扩散 kuo4 san4
疏散 shu1 san4
散会 san4 hui4
散心 san4 xin1
散热 san4 re4
散漫 san3 man4
散装 san3 zhuang1
散沙 san3 sha1
闲散 xian2 san3
零散 ling2 san3
丧失 sang4 shi1
丧气 sang4 qi4
沮丧 ju3 sang4
懊丧 ao4 sang4
颓丧 tui2 sang4
丧心病狂 sang4 xin1 bing4 kuang2
丧事 sang1 shi4
丧礼 sang1 li3
丧葬 sang1 zang4
奔丧 ben1 sang1
治丧 zhi4 sang1
扫除 sao3 chu2
清扫 qing1 sao3
扫描 sao3 miao2
扫盲 sao3 mang2
扫把 sao4 ba3
颜色 yan2 se4
色彩 se4 cai3
景色 jing3 se4
特色 te4 se4
色子 shai3 zi3
掷色子 zhi4 shai3 zi3
堵塞 du3 se4
阻塞 zu3 se4
闭塞 bi4 se4
塞车 sai1 che1
塞子 sai1 zi3
瓶塞 ping2 sai1
塞进 sai1 jin4
活塞 huo2 sai1
要塞 yao4 sai4
边塞 bian1 sai4
塞外 sai4 wai4
塞翁失马 sai4 weng1 shi1 ma3
煞费苦心 sha4 fei4 ku3 xin1
煞风景 sha1 feng1 jing3
煞车 sha1 che1
煞白 sha4 bai2
大厦 da4 sha4
厦门 xia4 men2
杉树 shan1 shu4
水杉 shui3 shan1
杉木 sha1 mu4
少将 shao4 jiang4
少先队 shao4 xian1 dui4
多少 duo1 shao3
减少 jian3 shao3
缺少 que1 shao3
至少 zhi4 shao3
折断 zhe2 duan4
折叠 zhe2 die2
折磨 zhe2 mo5
挫折 cuo4 zhe2
骨折 gu3 zhe2
夭折 yao1 zhe2
折秤 she2 cheng4
绳子折了 sheng2 zi3 she2 le5
舍得 she3 de2
舍弃 she3 qi4
施舍 shi1 she3
舍己为人 she3 ji3 wei4 ren2
房舍 fang2 she4
寒舍 han2 she4
什锦 shi2 jin3
家什 jia1 shi5
识别 shi2 bie2
认识 ren4 shi5
知识 zhi1 shi5
常识 chang2 shi2
意识 yi4 shi5
标识 biao1 zhi4
博闻强识 bo2 wen2 qiang2 zhi4
似乎 si4 hu1
类似 lei4 si4
近似 jin4 si4
似笑非笑 si4 xiao4 fei1 xiao4
成熟 cheng2 shu2
熟悉 shu2 xi1
熟练 shu2 lian4
熟人 shu2 ren2
烂熟 lan4 shu2
说话 shuo1 hua4
说明 shuo1 ming2
游说 you2 shui4
说客 shui4 ke4
住宿 zhu4 su4
宿营 su4 ying2
宿愿 su4 yuan4
一宿 yi1 xiu3
半宿 ban4 xiu3
星宿 xing1 xiu4
二十八宿 er4 shi2 ba1 xiu4
吓唬 xia4 hu5
惊吓 jing1 xia4
吓人 xia4 ren2
恐吓 kong3 he4
恫吓 dong4 he4
威吓 wei1 he4
新鲜 xin1 xian1
鲜花 xian1 hua1
鲜艳 xian1 yan4
鲜美 xian1 mei3
海鲜 hai3 xian1
鲜为人知 xian3 wei4 ren2 zhi1
朝鲜 chao2 xian3
鲜见 xian3 jian4
屡见不鲜 lv3 jian4 bu4 xian1
削减 xue1 jian3
削弱 xue1 ruo4
削足适履 xue1 zu2 shi4 lv3
削苹果 xiao1 ping2 guo3
削皮 xiao1 pi2
削铅笔 xiao1 qian1 bi3
旋转 xuan2 zhuan4
旋律 xuan2 lv4
盘旋 pan2 xuan2
螺旋 luo2 xuan2
凯旋 kai3 xuan2
旋风 xuan4 feng1
旋床 xuan4 chuang2
殷切 yin1 qie4
殷勤 yin1 qin2
殷实 yin1 shi2
殷红 yan1 hong2
咽炎 yan1 yan2
吞咽 tun1 yan4
下咽 xia4 yan4
咽气 yan4 qi4
锁钥 suo3 yue4
晕倒 yun1 dao3
头晕 tou2 yun1
眩晕 xuan4 yun1
晕车 yun4 che1
晕船 yun4 chuan2
晕机 yun4 ji1
红晕 hong2 yun4
日晕 ri4 yun4
月晕 yue4 yun4
千载难逢 qian1 zai3 nan2 feng2
载客 zai4 ke4
载货 zai4 huo4
装载 zhuang1 zai4
运载 yun4 zai4
超载 chao1 zai4
载歌载舞 zai4 ge1 zai4 wu3
满载而归 man3 zai4 er2 gui1
咱们 zan2 men5
选择 xuan3 ze2
择优 ze2 you1
择业 ze2 ye4
择菜 zhai2 cai4
择席 zhai2 xi2
挣扎 zheng1 zha2
扎实 zha1 shi2
扎根 zha1 gen1
扎针 zha1 zhen1
驻扎 zhu4 zha1
包扎 bao1 za1
捆扎 kun3 za1
扎辫子 za1 bian4 zi3
轧钢 zha2 gang1
轧辊 zha2 gun3
倾轧 qing1 ya4
轧棉花 ya4 mian2 hua1
粘贴 zhan1 tie1
粘连 zhan1 lian2
粘住 zhan1 zhu4
粘液 nian2 ye4
粘稠 nian2 chou2
粘土 nian2 tu3
上涨 shang4 zhang3
涨价 zhang3 jia4
涨潮 zhang3 chao2
高涨 gao1 zhang3
涨红 zhang4 hong2
涨红了脸 zhang4 hong2 le5 lian3
头昏脑涨 tou2 hun1 nao3 zhang4
爪子 zhua3 zi3
爪哇 zhao3 wa1
鹰爪 ying1 zhao3
魔爪 mo2 zhao3
张牙舞爪 zhang1 ya2 wu3 zhao3
转变 zhuan3 bian4
转换 zhuan3 huan4
转移 zhuan3 yi2
转折 zhuan3 zhe2
转告 zhuan3 gao4
转动 zhuan4 dong4
转圈 zhuan4 quan1
转盘 zhuan4 pan2
转椅 zhuan4 yi3
转悠 zhuan4 you5
自转 zi4 zhuan4
公转 gong1 zhuan4
一幢 yi1 zhuang4
幢幢 chuang2 chuang2
人影幢幢 ren2 ying3 chuang2 chuang2
仔细 zi3 xi4
仔猪 zi3 zhu1
牛仔 niu2 zai3
牛仔裤 niu2 zai3 ku4
钻探 zuan1 tan4
钻井 zuan1 jing3
钻进 zuan1 jin4
钻戒 zuan4 jie4
作坊 zuo1 fang5
自作自受 zi4 zuo4 zi4 shou4
朝夕 zhao1 xi1
朝三暮四 zhao1 san1 mu4 si4
朝令夕改 zhao1 ling4 xi1 gai3
朝代 chao2 dai4
朝廷 chao2 ting2
王朝 wang2 chao2
唐朝 tang2 chao2
清朝 qing1 chao2
朝圣 chao2 sheng4
朝拜 chao2 bai4
奇偶 ji1 ou3
奇怪 qi2 guai4
奇迹 qi2 ji4
神奇 shen2 qi2
骑兵 qi2 bing1
骑马 qi2 ma3
骑车 qi2 che1
铁骑 tie3 qi2
模型 mo2 xing2
模范 mo2 fan4
模仿 mo2 fang3
模糊 mo2 hu5
规模 gui1 mo2
楷模 kai3 mo2
模子 mu2 zi3
装模作样 zhuang1 mu2 zuo4 yang4
一模一样 yi1 mu2 yi1 yang4
磨刀 mo2 dao1
磨练 mo2 lian4
磨损 mo2 sun3
琢磨 zhuo2 mo5
消磨 xiao1 mo2
磨坊 mo4 fang2
磨盘 mo4 pan2
石磨 shi2 mo4
磨面 mo4 mian4
泥巴 ni2 ba1
水泥 shui3 ni2
泥泞 ni2 ning4
泥古 ni4 gu3
屏幕 ping2 mu4
屏障 ping2 zhang4
屏风 ping2 feng1
荧屏 ying2 ping2
屏息 bing3 xi1
屏气 bing3 qi4
屏除 bing3 chu2
屏弃 bing3 qi4
铺位 pu4 wei4
床铺 chuang2 pu4
卧铺 wo4 pu4
上铺 shang4 pu4
下铺 xia4 pu4
铺路 pu1 lu4
铺设 pu1 she4
铺垫 pu1 dian4
铺张 pu1 zhang1
铺天盖地 pu1 tian1 gai4 di4
简朴 jian3 pu3
质朴 zhi4 pu3
姓朴 xing4 piao2
强大 qiang2 da4
强壮 qiang2 zhuang4
坚强 jian1 qiang2
强迫 qiang3 po4
强词夺理 qiang3 ci2 duo2 li3
强人所难 qiang3 ren2 suo3 nan2
强求 qiang3 qiu2
悄悄 qiao1 qiao1
静悄悄 jing4 qiao1 qiao1
悄然 qiao3 ran2
悄声 qiao3 sheng1
悄无声息 qiao3 wu2 sheng1 xi1
翘首 qiao2 shou3
翘楚 qiao2 chu3
连翘 lian2 qiao2
翘尾巴 qiao4 wei3 ba5
翘课 qiao4 ke4
翘板 qiao4 ban3
切开 qie1 kai1
切割 qie1 ge1
切菜 qie1 cai4
切除 qie1 chu2
切断 qie1 duan4
切记 qie4 ji4
亲戚 qin1 qi5
亲爱 qin1 ai4
亲人 qin1 ren2
母亲 mu3 qin1
父亲 fu4 qin1
亲家 qing4 jia5
衣裳 yi1 shang5
霓裳 ni2 chang2
稍微 shao1 wei1
稍等 shao1 deng3
稍息 shao4 xi1
石头 shi2 tou5
石油 shi2 you2
岩石 yan2 shi2
石子 shi2 zi3
一石粮食 yi1 dan4 liang2 shi5
拾取 shi2 qu3
拾金不昧 shi2 jin1 bu4 mei4
收拾 shou1 shi5
拾级而上 she4 ji2 er2 shang4
属于 shu3 yu2
属性 shu3 xing4
金属 jin1 shu3
家属 jia1 shu3
下属 xia4 shu3
属意 zhu3 yi4
属望 zhu3 wang4
衰老 shuai1 lao3
衰退 shuai1 tui4
衰弱 shuai1 ruo4
兴衰 xing1 shuai1
鬓毛衰 bin4 mao2 cui1
缩小 suo1 xiao3
收缩 shou1 suo1
压缩 ya1 suo1
退缩 tui4 suo1
提高 ti2 gao1
提供 ti2 gong1
提出 ti2 chu1
提前 ti2 qian2
提醒 ti2 xing3
提溜 di1 liu5
吐痰 tu3 tan2
吞吐 tun1 tu3
谈吐 tan2 tu3
吐露 tu3 lu4
上吐下泻 shang4 tu4 xia4 xie4
开拓 kai1 tuo4
拓展 tuo4 zhan3
拓宽 tuo4 kuan1
拓荒 tuo4 huang1
拓片 ta4 pian4
拓本 ta4 ben3
委员 wei3 yuan2
委托 wei3 tuo1
委屈 wei3 qu1
委婉 wei3 wan3
委蛇 wei1 yi2
虚与委蛇 xu1 yu3 wei1 yi2
尾巴 wei3 ba5
结尾 jie2 wei3
尾随 wei3 sui2
马尾 ma3 wei3
尾声 wei3 sheng1
树荫 shu4 yin1
荫凉 yin4 liang2
荫庇 yin4 bi4
福荫 fu2 yin4
佣人 yong1 ren2
雇佣 gu4 yong1
女佣 nv3 yong1
佣金 yong4 jin1
佣钱 yong4 qian2
与会 yu4 hui4
与闻 yu4 wen2
参与 can1 yu4
与其 yu3 qi2
给与 ji3 yu3
占卦 zhan1 gua4
占星 zhan1 xing1
占有 zhan4 you3
霸占 ba4 zhan4
攻占 gong1 zhan4
侵占 qin1 zhan4
症状 zheng4 zhuang4
病症 bing4 zheng4
炎症 yan2 zheng4
对症下药 dui4 zheng4 xia4 yao4
症结 zheng1 jie2
繁殖 fan2 zhi2
殖民 zhi2 min2
养殖 yang3 zhi2
生殖 sheng1 zhi2
骨殖 gu3 shi5
纵横 zong4 heng2
放纵 fang4 zong4
操纵 cao1 zong4
纵容 zong4 rong2
纵身 zong4 shen1
挑选 tiao1 xuan3
挑拣 tiao1 jian3
挑剔 tiao1 ti5
挑食 tiao1 shi2
挑担 tiao1 dan4
挑逗 tiao3 dou4
挑灯 tiao3 deng1
囤积 tun2 ji1
囤货 tun2 huo4
粮囤 liang2 dun4
驮运 tuo2 yun4
驮东西 tuo2 dong1 xi5
驮子 duo4 zi3
熨斗 yun4 dou3
熨烫 yun4 tang4
熨衣服 yun4 yi1 fu5
熨帖 yu4 tie1
呼吁 hu1 yu4
吁请 yu4 qing3
长吁短叹 chang2 xu1 duan3 tan4
气喘吁吁 qi4 chuan3 xu1 xu1
积攒 ji1 zan3
攒钱 zan3 qian2
攒动 cuan2 dong4
人头攒动 ren2 tou2 cuan2 dong4
心脏 xin1 zang4
肝脏 gan1 zang4
内脏 nei4 zang4
脏腑 zang4 fu3
肮脏 ang1 zang1
脏水 zang1 shui3
脏话 zang1 hua4
脏东西 zang1 dong1 xi5
确凿 que4 zao2
凿子 zao2 zi3
开凿 kai1 zao2
凿井 zao2 jing3
开辟 kai1 pi4
辟谣 pi4 yao2
精辟 jing1 pi4
透辟 tou4 pi4
复辟 fu4 bi4
辟邪 bi4 xie2
漂洗 piao3 xi3
正月初一 zheng1 yue4 chu1 yi1
新正 xin1 zheng1
蛤蟆 ha2 ma5
蛤蜊 ge2 li2
文蛤 wen2 ge2
巷子 xiang4 zi3
小巷 xiao3 xiang4
街巷 jie1 xiang4
巷道 hang4 dao4
矿巷 kuang4 hang4
彩虹 cai3 hong2
虹桥 hong2 qiao2
哄骗 hong3 pian4
哄孩子 hong3 hai2 zi3
哄堂大笑 hong1 tang2 da4 xiao4
乱哄哄 luan4 hong1 hong1
起哄 qi3 hong4
一哄而散 yi1 hong4 er2 san4
豁达 huo4 da2
豁免 huo4 mian3
豁口 huo1 kou3
豁出去 huo1 chu1 qu4
豁嘴 huo1 zui3
骨气 gu3 qi4
骨骼 gu3 ge2
骨肉 gu3 rou4
排骨 pai2 gu3
骨碌 gu1 lu5
骨朵 gu1 duo5
花骨朵 hua1 gu1 duo5
壳郎猪 ke2 lang5 zhu1
奔跑 ben1 pao3
奔驰 ben1 chi2
奔腾 ben1 teng2
飞奔 fei1 ben1
私奔 si1 ben1
奔头 ben4 tou5
直奔 zhi2 ben4
扒开 ba1 kai1
扒拉 ba1 la1
扒车 ba1 che1
扒手 pa2 shou3
扒窃 pa2 qie4
扒鸡 pa2 ji1
膀子 bang3 zi3
翅膀 chi4 bang3
肩膀 jian1 bang3
膀胱 pang2 guang1
磅秤 bang4 cheng4
过磅 guo4 bang4
磅礴 pang2 bo2
气势磅礴 qi4 shi4 pang2 bo2
刨坑 pao2 keng1
刨土 pao2 tu3
刨根问底 pao2 gen1 wen4 di3
刨床 bao4 chuang2
刨子 bao4 zi3
刨花 bao4 hua1
暴晒 bao4 shai4
一暴十寒 yi1 pu4 shi2 han2
手臂 shou3 bi4
臂膀 bi4 bang3
助一臂之力 zhu4 yi1 bi4 zhi1 li4
胳臂 ge1 bei5
扁平 bian3 ping2
扁担 bian3 dan4
压扁 ya1 bian3
扁舟 pian1 zhou1
一叶扁舟 yi1 ye4 pian1 zhou1
叉子 cha1 zi3
交叉 jiao1 cha1
鱼叉 yu2 cha1
叉腰 cha1 yao1
劈叉 pi3 cha4
叉开 cha4 kai1
刹车 sha1 che1
急刹 ji2 sha1
古刹 gu3 cha4
刹那 cha4 na4
一刹那 yi1 cha4 na4
澄清 cheng2 qing1
澄澈 cheng2 che4
澄沙 deng4 sha1
澄清液体 deng4 qing1 ye4 ti3
臭味 chou4 wei4
臭气 chou4 qi4
恶臭 e4 chou4
乳臭未干 ru3 xiu4 wei4 gan1
铜臭 tong2 xiu4
无色无臭 wu2 se4 wu2 xiu4
揣测 chuai3 ce4
揣摩 chuai3 mo2
怀揣 huai2 chuai1
揣在怀里 chuai1 zai4 huai2 li3
逮捕 dai4 bu3
逮住 dai3 zhu4
逮老鼠 dai3 lao3 shu3
掸子 dan3 zi3
鸡毛掸子 ji1 mao2 dan3 zi3
掸邦 shan4 bang1
叨唠 dao1 lao5
唠叨 lao2 dao5
叨扰 tao1 rao3
叨光 tao1 guang1
目的地 mu4 di4 di4
有的放矢 you3 di4 fang4 shi3
无的放矢 wu2 di4 fang4 shi3
坊间 fang1 jian1
牌坊 pai2 fang1
街坊 jie1 fang5
染坊 ran3 fang2
油坊 you2 fang2
妄自菲薄 wang4 zi4 fei3 bo2
芳菲 fang1 fei1
菲律宾 fei1 lv4 bin1
扛枪 kang2 qiang1
扛东西 kang2 dong1 xi5
力能扛鼎 li4 neng2 gang1 ding3
咯血 ka3 xie3
咯咯 ge1 ge1
咯吱 ge1 zhi1
乌龟 wu1 gui1
龟缩 gui1 suo1
龟裂 jun1 lie4
龟兹 qiu1 ci2
吭声 keng1 sheng1
一声不吭 yi1 sheng1 bu4 keng1
引吭高歌 yin3 hang2 gao1 ge1
貉子 hao2 zi3
一丘之貉 yi1 qiu1 zhi1 he2
浒水 hu3 shui3
水浒 shui3 hu3
唬人 hu3 ren2
哗然 hua2 ran2
喧哗 xuan1 hua2
哗变 hua2 bian4
哗哗 hua1 hua1
哗啦 hua1 la1
徘徊 pai2 huai2
徊肠伤气 huai2 chang2 shang1 qi4
人参 ren2 shen1
海参 hai3 shen1
党参 dang3 shen1
参商 shen1 shang1
参宿 shen1 xiu4
参加 can1 jia1
参考 can1 kao3
参观 can1 guan1
创伤 chuang1 shang1
重创 zhong4 chuang1
创口 chuang1 kou3
创可贴 chuang1 ke3 tie1
创造 chuang4 zao4
创新 chuang4 xin1
创业 chuang4 ye4
纤维 xian1 wei2
纤细 xian1 xi4
纤夫 qian4 fu1
拉纤 la1 qian4
纤绳 qian4 sheng2
烙印 lao4 yin4
烙饼 lao4 bing3
烙铁 lao4 tie5
炮烙 pao2 luo4
炮制 pao2 zhi4
如法炮制 ru2 fa3 pao2 zhi4
炮仗 pao4 zhang5
鞭炮 bian1 pao4
大炮 da4 pao4
泡沫 pao4 mo4
泡茶 pao4 cha2
气泡 qi4 pao4
灯泡 deng1 pao4
眼泡 yan3 pao1
豆腐泡 dou4 fu5 pao1
撇开 pie1 kai1
撇弃 pie1 qi4
撇嘴 pie3 zui3
撇捺 pie3 na4
仆人 pu2 ren2
仆从 pu2 cong2
奴仆 nu2 pu2
公仆 gong1 pu2
前仆后继 qian2 pu1 hou4 ji4
仆倒 pu1 dao3
稽查 ji1 cha2
稽核 ji1 he2
滑稽 hua2 ji1
无稽之谈 wu2 ji1 zhi1 tan2
稽首 qi3 shou3
蹊跷 qi1 qiao5
蹊径 xi1 jing4
另辟蹊径 ling4 pi4 xi1 jing4
呛水 qiang1 shui3
呛着了 qiang1 zhao2 le5
够呛 gou4 qiang4
呛人 qiang4 ren2
绷带 beng1 dai4
绷紧 beng1 jin3
紧绷 jin3 beng1
绷着脸 beng3 zhe5 lian3
秘密 mi4 mi4
秘书 mi4 shu1
神秘 shen2 mi4
便秘 bian4 mi4
秘鲁 bi4 lu3
颠簸 dian1 bo3
簸扬 bo3 yang2
簸箕 bo4 ji5
场院 chang2 yuan4
打场 da3 chang2
一场大雨 yi1 chang2 da4 yu3
场合 chang3 he2
市场 shi4 chang3
现场 xian4 chang3
碉堡 diao1 bao3
堡垒 bao3 lei3
城堡 cheng2 bao3
桥头堡 qiao2 tou2 bao3
十里堡 shi2 li3 pu4
吴堡 wu2 bu3
瓦窑堡 wa3 yao2 bu3
柴沟堡 chai2 gou1 bu3
吐蕃 tu3 bo1
番禺 pan1 yu2
番茄 fan1 qie2
轮番 lun2 fan1
东莞 dong1 guan3
莞尔 wan3 er3
莞尔一笑 wan3 er3 yi1 xiao4
荥阳 xing2 yang2
荥经 ying2 jing1
蚌埠 beng4 bu4
河蚌 he2 bang4
蛤蚌 ge2 bang4
鹬蚌相争 yu4 bang4 xiang1 zheng1
分泌 fen1 mi4
泌尿 mi4 niao4
泌阳 bi4 yang2
铅笔 qian1 bi3
铅球 qian1 qiu2
铅山 yan2 shan1
洪洞 hong2 tong2
洞穴 dong4 xue2
乐亭 lao4 ting2
乐清 yue4 qing1
丽水 li2 shui3
高丽 gao1 li2
丽江 li4 jiang1
美丽 mei3 li4
台州 tai1 zhou1
天台山 tian1 tai1 shan1
六安 lu4 an1
六合 lu4 he2
百色 bo2 se4
会稽 kuai4 ji1
会计师 kuai4 ji4 shi1
财会 cai2 kuai4
压根 ya4 gen1
压根儿 ya4 gen1 er2
压力 ya1 li4
压迫 ya1 po4
自怨自艾 zi4 yuan4 zi4 yi4
方兴未艾 fang1 xing1 wei4 ai4
艾草 ai4 cao3
熬夜 ao2 ye4
熬粥 ao2 zhou1
煎熬 jian1 ao2
熬菜 ao1 cai4
拗口 ao4 kou3
执拗 zhi2 niu4
拗断 ao3 duan4
脊椎 ji3 zhui1
椎骨 zhui1 gu3
椎心泣血 chui2 xin1 qi4 xue4
铁椎 tie3 chui2
俩人 lia3 ren2
公俩 gong1 liang3
罢工 ba4 gong1
罢了 ba4 le5
罢休 ba4 xiu1
作罢 zuo4 ba4
吱声 zi1 sheng1
吱吱 zhi1 zhi1
吱呀 zhi1 ya1
嘎吱 ga1 zhi1
咋办 za3 ban4
咋呼 zha1 hu5
咋舌 ze2 she2
潜移默化 qian2 yi2 mo4 hua4
打更 da3 geng1
五更 wu3 geng1
半夜三更 ban4 ye4 san1 geng1
自食其果 zi4 shi2 qi2 guo3
箪食壶浆 dan1 si4 hu2 jiang1
食言 shi2 yan2
饮食 yin3 shi2
零食 ling2 shi2
窥伺 kui1 si4
环伺 huan2 si4
熟稔 shu2 ren3
谙熟 an1 shu2
徇私 xun4 si1
徇情 xun4 qing2
殉职 xun4 zhi2
殉葬 xun4 zang4
畜力 chu4 li4
六畜 liu4 chu4
畜产品 xu4 chan3 pin3
遂心 sui4 xin1
遂愿 sui4 yuan4
未遂 wei4 sui4
半身不遂 ban4 shen1 bu4 sui2
毛遂自荐 mao2 sui4 zi4 jian4
汤药 tang1 yao4
米汤 mi3 tang1
汤汤 shang1 shang1
浩浩汤汤 hao4 hao4 shang1 shang1
趟水 tang1 shui3
趟地 tang1 di4
一趟 yi1 tang4
几趟 ji3 tang4
帖子 tie3 zi3
请帖 qing3 tie3
喜帖 xi3 tie3
字帖 zi4 tie4
碑帖 bei1 tie4
临帖 lin2 tie4
妥帖 tuo3 tie1
服帖 fu2 tie1
俯首帖耳 fu3 shou3 tie1 er3
尽管 jin3 guan3
尽量 jin3 liang4
尽快 jin3 kuai4
尽早 jin3 zao3
尽可能 jin3 ke3 neng2
不禁 bu4 jin1
禁不住 jin1 bu4 zhu4
禁受 jin1 shou4
情不自禁 qing2 bu4 zi4 jin1
弱不禁风 ruo4 bu4 jin1 feng1
太监 tai4 jian4
国子监 guo2 zi3 jian4
迫击炮 pai3 ji1 pao4
体己 ti1 ji3
上声 shang3 sheng1
甚么 shen2 me5
论语 lun2 yu3
结实 jie1 shi5
结巴 jie1 ba5
结结巴巴 jie1 jie1 ba1 ba1
"""

PHRASES = {}
for _line in _PHRASES_RAW.strip().splitlines():
    _parts = _line.split()
    if len(_parts) >= 2 and len(_parts[0]) == len(_parts) - 1:
        PHRASES[_parts[0]] = _parts[1:]

# single-character readings keyed by jieba POS prefix: used when a char
# stands alone as its own word and its reading tracks word class
POS_READINGS = {
    "还": {"v": "huan2"},    # 还(v)钱 vs 还(d)没
    "数": {"v": "shu3", "m": "shu3"},     # 数(v)钱 vs 数(n)字
    "量": {"v": "liang2"},   # 量(v)体温 vs 重量
    "盛": {"v": "cheng2"},   # 盛(v)饭 vs 盛大
    "中": {"v": "zhong4"},   # 中(v)奖 vs 中间
    "长": {"v": "zhang3"},   # 长(v)大 vs 很长
    "干": {"v": "gan4"},     # 干(v)活 vs 干净
    "空": {"v": "kong4"},    # 空(v)出 vs 天空
    "划": {"v": "hua2"},     # 划(v)船 vs 计划
    "咽": {"v": "yan4"},     # 咽(v)下 vs 咽喉
}

# round-4 polyphone-battery additions
PHRASES["还钱"] = ["huan2", "qian2"]
PHRASES["睡着"] = ["shui4", "zhao2"]
PHRASES["了如指掌"] = ["liao3", "ru2", "zhi3", "zhang3"]
PHRASES["到处"] = ["dao4", "chu4"]
PHRASES["长得"] = ["zhang3", "de5"]
PHRASES["倒是"] = ["dao4", "shi4"]
PHRASES["当差"] = ["dang1", "chai1"]
PHRASES["重担"] = ["zhong4", "dan4"]
PHRASES["卡住"] = ["qia3", "zhu4"]
PHRASES["披散"] = ["pi1", "san3"]
PHRASES["挑起"] = ["tiao3", "qi3"]
PHRASES["压轴"] = ["ya1", "zhou4"]
PHRASES["柏林"] = ["bo2", "lin2"]
PHRASES["华山"] = ["hua4", "shan1"]
PHRASES["数钱"] = ["shu3", "qian2"]
PHRASES["猪圈"] = ["zhu1", "juan4"]
PHRASES["羊圈"] = ["yang2", "juan4"]
PHRASES["圈养"] = ["juan4", "yang3"]
PHRASES["差别"] = ["cha1", "bie2"]
PHRASES["差距"] = ["cha1", "ju4"]
PHRASES["差异"] = ["cha1", "yi4"]
PHRASES["偏差"] = ["pian1", "cha1"]
PHRASES["误差"] = ["wu4", "cha1"]
PHRASES["温差"] = ["wen1", "cha1"]
PHRASES["时差"] = ["shi2", "cha1"]
PHRASES["反差"] = ["fan3", "cha1"]
PHRASES["差价"] = ["cha1", "jia4"]
PHRASES["差额"] = ["cha1", "e2"]
PHRASES["出差"] = ["chu1", "chai1"]
PHRASES["差遣"] = ["chai1", "qian3"]
PHRASES["邮差"] = ["you2", "chai1"]
PHRASES["薄弱"] = ["bo2", "ruo4"]
PHRASES["单薄"] = ["dan1", "bo2"]
PHRASES["淡薄"] = ["dan4", "bo2"]
PHRASES["刻薄"] = ["ke4", "bo2"]
PHRASES["薄雾"] = ["bo2", "wu4"]
PHRASES["薄膜"] = ["bo2", "mo2"]
PHRASES["子弹"] = ["zi3", "dan4"]
PHRASES["炸弹"] = ["zha4", "dan4"]
PHRASES["导弹"] = ["dao3", "dan4"]
PHRASES["弹药"] = ["dan4", "yao4"]
PHRASES["弹壳"] = ["dan4", "ke2"]
PHRASES["枪弹"] = ["qiang1", "dan4"]
PHRASES["眼泡"] = ["yan3", "pao1"]
PHRASES["灯泡"] = ["deng1", "pao4"]
PHRASES["摔倒"] = ["shuai1", "dao3"]
PHRASES["倒下"] = ["dao3", "xia4"]
PHRASES["倒闭"] = ["dao3", "bi4"]
PHRASES["倒霉"] = ["dao3", "mei2"]
PHRASES["跌倒"] = ["die1", "dao3"]
PHRASES["打倒"] = ["da3", "dao3"]
PHRASES["背着"] = ["bei1", "zhe5"]
PHRASES["咽喉"] = ["yan1", "hou2"]
PHRASES["分差"] = ["fen1", "cha1"]
PHRASES["日薄西山"] = ["ri4", "bo2", "xi1", "shan1"]
PHRASES["干完"] = ["gan4", "wan2"]
PHRASES["空出"] = ["kong4", "chu1"]
PHRASES["划着"] = ["hua2", "zhe5"]
PHRASES["两只手"] = ["liang3", "zhi1", "shou3"]
PHRASES["雪地"] = ["xue3", "di4"]
PHRASES["一家之长"] = ["yi1", "jia1", "zhi1", "zhang3"]
PHRASES["大喝"] = ["da4", "he4"]
PHRASES["转着"] = ["zhuan4", "zhe5"]
PHRASES["还钱"] = ["huan2", "qian2"]
PHRASES["中奖"] = ["zhong4", "jiang3"]
PHRASES["一觉"] = ["yi1", "jiao4"]
PHRASES["供品"] = ["gong4", "pin3"]
PHRASES["露出"] = ["lou4", "chu1"]
PHRASES["抛头露面"] = ["pao1", "tou2", "lu4", "mian4"]
PHRASES["混浊"] = ["hun2", "zhuo2"]
PHRASES["混蛋"] = ["hun2", "dan4"]
PHRASES["片子"] = ["pian1", "zi5"]
PHRASES["威吓"] = ["wei1", "he4"]
PHRASES["恐吓"] = ["kong3", "he4"]
PHRASES["吓唬"] = ["xia4", "hu5"]
PHRASES["抹布"] = ["ma1", "bu4"]
PHRASES["抹平"] = ["mo4", "ping2"]
PHRASES["闷气"] = ["men4", "qi4"]
PHRASES["哄堂大笑"] = ["hong1", "tang2", "da4", "xiao4"]
PHRASES["起哄"] = ["qi3", "hong4"]
PHRASES["哄抢"] = ["hong1", "qiang3"]
PHRASES["倒进"] = ["dao4", "jin4"]
PHRASES["倒入"] = ["dao4", "ru4"]
PHRASES["倒出"] = ["dao4", "chu1"]
PHRASES["倒掉"] = ["dao4", "diao4"]
