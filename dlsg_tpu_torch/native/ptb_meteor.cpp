// Native metric components: PTB tokenizer + Porter2 stemmer + METEOR aligner.
//
// dlsg_tpu_torch's copy of dlsg_tpu/native/ptb_meteor.cpp: equivalents of the
// reference's two Java components (stanford-corenlp-3.4.1.jar tokenizer and
// meteor-1.5.jar — see caption-eval/pycocoevalcap/tokenizer/ptbtokenizer.py:18-53
// and caption-eval/pycocoevalcap/meteor/meteor.py:12-47). Behavior is kept
// bit-identical to the Python implementations in dlsg_tpu_torch/metrics
// (tokenizer.py, stemmer.py, meteor.py); tests/test_torch_native.py holds
// the two to each other and to the JAX package's build of the same source.
//
// Built at first use by dlsg_tpu_torch/native/__init__.py
// (g++ -O2 -std=c++17 -fPIC -shared) and loaded with ctypes.

#include <algorithm>
#include <array>
#include <cctype>
#include <cstring>
#include <fstream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <tuple>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PTB tokenizer (ASCII path; Python handles unicode pre-normalization)
// ---------------------------------------------------------------------------

bool is_word(char c) { return std::isalnum((unsigned char)c) || c == '_'; }

std::string replace_all(std::string s, const std::string& from, const std::string& to) {
  size_t pos = 0;
  while ((pos = s.find(from, pos)) != std::string::npos) {
    s.replace(pos, from.size(), to);
    pos += to.size();
  }
  return s;
}

std::string ptb_tokenize(const std::string& line, bool lowercase) {
  std::string s = line;
  if (lowercase)
    std::transform(s.begin(), s.end(), s.begin(),
                   [](unsigned char c) { return std::tolower(c); });

  // brackets -> PTB symbols
  s = replace_all(s, "(", " -LRB- ");
  s = replace_all(s, ")", " -RRB- ");
  s = replace_all(s, "{", " -LCB- ");
  s = replace_all(s, "}", " -RCB- ");
  s = replace_all(s, "[", " -LSB- ");  // corenlp PTB3: square brackets get their own tokens
  s = replace_all(s, "]", " -RSB- ");

  // double quotes: opening after start/space -> ``, else '' (the check reads
  // the ORIGINAL string, like python's re.sub left-to-right scan)
  {
    std::string out;
    for (size_t i = 0; i < s.size(); ++i) {
      if (s[i] == '"') {
        bool opening = (i == 0) || s[i - 1] == ' ' || s[i - 1] == '\t';
        out += opening ? " `` " : " '' ";
      } else {
        out += s[i];
      }
    }
    s = out;
  }

  s = replace_all(s, "...", " ... ");
  s = replace_all(s, "--", " -- ");

  // opening single quote -> ` (before the clitic rules so "'s" stays intact)
  {
    std::string out;
    for (size_t i = 0; i < s.size(); ++i) {
      if (s[i] == '\'' && (i == 0 || std::isspace((unsigned char)s[i - 1])) &&
          i + 1 < s.size() && is_word(s[i + 1])) {
        out += "` ";
      } else {
        out += s[i];
      }
    }
    s = out;
  }

  // split punctuation; , and : stay inside numbers (2,500 / 10:30) and &
  // stays inside compounds (a&b), like corenlp
  {
    std::string out;
    const std::string punct = ";@#$%?!";
    for (size_t i = 0; i < s.size(); ++i) {
      char c = s[i];
      bool split = false;
      if (punct.find(c) != std::string::npos) {
        split = true;
      } else if (c == '&') {
        bool wb = i > 0 && is_word(s[i - 1]);
        bool wa = i + 1 < s.size() && is_word(s[i + 1]);
        split = !(wb && wa);
      } else if (c == ',' || c == ':') {
        bool db = i > 0 && std::isdigit((unsigned char)s[i - 1]);
        bool da = i + 1 < s.size() && std::isdigit((unsigned char)s[i + 1]);
        split = !(db && da);
      }
      if (split) {
        out += ' ';
        out += c;
        out += ' ';
      } else {
        out += c;
      }
    }
    s = out;
  }

  // clitics — mirroring the Python side's SEPARATE re.sub passes (each pass
  // scans fresh, with its own resume-after-match semantics; a shared resume
  // across rules wrongly blocked the second rule in "shouldn't've"):
  //   pass 1: \b(\w+)(n't)\b       -> "\1 n't"
  //   pass 2: (\w)('s|'re|...)\b   -> split  (resume keeps "i'd've" intact)
  //   pass 3: (s)'(\s|$)           -> "s ' "
  //   pass 4: (?<=\w)'(?=\s|$)     -> " '"
  {
    std::string out;
    size_t resume = 0;  // the leading \w+ must start at or after the last match
    for (size_t i = 0; i < s.size();) {
      if (i + 2 < s.size() && s[i] == 'n' && s[i + 1] == '\'' && s[i + 2] == 't' &&
          i > 0 && is_word(s[i - 1]) && i - 1 >= resume &&
          (i + 3 == s.size() || !is_word(s[i + 3]))) {
        out += " n't";
        i += 3;
        resume = i;
        continue;
      }
      out += s[i];
      ++i;
    }
    s = out;
  }
  {
    std::string out;
    size_t resume = 0;  // re.sub resumes after each match ("i'd've" -> "i 'd've")
    for (size_t i = 0; i < s.size();) {
      if (s[i] == '\'' && i > 0 && is_word(s[i - 1]) && i - 1 >= resume &&
          i + 1 < s.size()) {
        std::string rest = s.substr(i + 1);
        auto boundary = [&](size_t len) {
          return rest.size() == len || !is_word(rest[len]);
        };
        if ((rest.rfind("s", 0) == 0 && boundary(1)) ||
            (rest.rfind("d", 0) == 0 && boundary(1)) ||
            (rest.rfind("m", 0) == 0 && boundary(1))) {
          out += " '";
          out += rest[0];
          i += 2;
          resume = i;
          continue;
        }
        if ((rest.rfind("re", 0) == 0 && boundary(2)) ||
            (rest.rfind("ve", 0) == 0 && boundary(2)) ||
            (rest.rfind("ll", 0) == 0 && boundary(2))) {
          out += " '";
          out += rest.substr(0, 2);
          i += 3;
          resume = i;
          continue;
        }
      }
      out += s[i];
      ++i;
    }
    s = out;
  }
  {
    std::string out;
    for (size_t i = 0; i < s.size();) {
      // plural possessive: s' followed by space/eos
      if (s[i] == '\'' && i > 0 && s[i - 1] == 's' &&
          (i + 1 == s.size() || std::isspace((unsigned char)s[i + 1]))) {
        out += " ' ";
        i += 1;
        continue;
      }
      // closing single quote after a word: expert' -> expert '
      if (s[i] == '\'' && i > 0 && is_word(s[i - 1]) &&
          (i + 1 == s.size() || std::isspace((unsigned char)s[i + 1]))) {
        out += " '";
        i += 1;
        continue;
      }
      out += s[i];
      ++i;
    }
    s = out;
  }

  // special contractions
  struct Pair { const char* a; const char* b; };
  static const Pair contractions[] = {
      {"cannot", "can not"}, {"d'ye", "d' ye"}, {"gimme", "gim me"},
      {"gonna", "gon na"},   {"gotta", "got ta"}, {"lemme", "lem me"},
      {"wanna", "wan na"},
  };
  {
    std::istringstream iss(s);
    std::string tok, out;
    while (iss >> tok) {
      bool replaced = false;
      for (const auto& p : contractions) {
        if (tok == p.a) {
          out += p.b;
          out += ' ';
          replaced = true;
          break;
        }
      }
      if (!replaced) {
        out += tok;
        out += ' ';
      }
    }
    s = out;
  }

  // PTB3 escaping: corenlp 3.4.1's PTBLexer default escapeForwardSlashAsterisk
  // =true emits "\/" and "\*" inside tokens ("and/or" -> "and\/or")
  s = replace_all(s, "/", "\\/");
  s = replace_all(s, "*", "\\*");

  // final pass: a trailing period becomes its own token unless the token is
  // a known abbreviation, a single initial (b.), or an ellipsis.
  // TWO classes mirroring corenlp PTBLexer's lookahead design — keep in sync
  // with tokenizer.py ABBREV_ALWAYS / ABBREV_CONTEXTUAL
  // (test_abbreviation_engine_sync):
  //  - ALWAYS: period stays in any position (titles, company, Latin).
  //  - CONTEXTUAL: period stays only when NOT line-final (months, days,
  //    states, streets, measures, entries colliding with common words) —
  //    the ambiguity PTBLexer resolves with JFlex lookahead.
  static const std::set<std::string> kAbbrevAlways = {
      "dr.", "mr.", "mrs.", "ms.", "jr.", "sr.", "prof.", "gen.",
      "gov.", "sgt.", "capt.", "rev.", "hon.", "u.s.", "u.k.", "e.g.",
      "i.e.", "etc.", "vs.", "co.", "inc.", "ltd.",
      "dept.", "approx.", "hr.", "a.m.", "p.m.",
      "lt.", "col.", "maj.", "adm.", "sen.", "pres.", "supt.", "det.",
      "misc.", "vol.", "ch.", "pp.", "univ.", "assn.",
      "bros.", "corp.", "mfg.", "ph.d.",
      "adj.", "adv.", "asst.", "bldg.", "cmdr.", "comdr.", "cpl.",
      "drs.", "ens.", "insp.", "messrs.", "mlle.", "mme.", "msgr.", "pfc.",
      "pvt.", "sens.", "sfc.", "surg.", "atty.", "attys.", "esq.",
      "cos.", "mfrs.", "mkt.", "pty.", "plc.", "dist.", "distrib.",
      "cf.", "al.", "seq.", "viz.", "ibid.", "orig.", "incl.", "nos.",
      "hrs.", "mins.", "secs.", "tsp.", "tbsp.",
      "exec.", "govt.", "natl.", "intl.", "admin.", "assoc.", "bldgs.",
      "mts.", "sts.", "rds."};
  static const std::set<std::string> kAbbrevContextual = {
      "st.", "ft.", "lb.", "lbs.", "oz.", "v.", "no.", "min.", "max.",
      "sec.", "in.", "gal.", "reps.", "rep.",
      "mt.", "ave.", "blvd.", "rd.", "hwy.", "fwy.", "pkwy.", "tpke.", "rte.",
      "jan.", "feb.", "mar.", "apr.", "jun.", "jul.", "aug.", "sept.",
      "oct.", "nov.", "dec.", "sep.",
      "mon.", "tues.", "wed.", "thurs.", "fri.", "sat.", "sun.",
      "ala.", "ariz.", "ark.", "calif.", "colo.", "conn.", "dak.", "del.",
      "fla.", "ind.", "kan.", "kans.", "mich.", "minn.", "mont.", "neb.",
      "nebr.", "nev.", "okla.", "ore.", "penn.", "penna.", "tenn.", "tex.",
      "wis.", "wisc.", "wyo.",
      "est.", "fig.", "ed.", "brig.",
      "kg.", "km.", "cm.", "mm.", "mi.", "qt.", "sq.", "cu."};
  // single-letter acronyms with internal periods ("u.s.a.", "t.v.") are
  // single tokens at corenlp — mirror tokenizer.py's _ACRONYM rule
  auto is_acronym = [](const std::string& t) {
    if (t.size() < 4 || t.size() % 2 != 0) return false;
    for (size_t i = 0; i < t.size(); i += 2) {
      if (!std::isalpha((unsigned char)t[i]) || t[i + 1] != '.') return false;
    }
    return true;
  };
  // Americanize filter (corenlp PTBLexer default americanize=true) — the same
  // caption-relevant subset as tokenizer.py: word map for internal-"our" /
  // "-re" forms, and the "-our -> -or" suffix rule (>=3 letters before "our",
  // with a keep-list for words like devour/contour).
  static const std::map<std::string, std::string> kAmericanize = {
      {"favourite", "favorite"}, {"favourites", "favorites"},
      {"colourful", "colorful"}, {"colourfully", "colorfully"},
      {"neighbourhood", "neighborhood"}, {"neighbourhoods", "neighborhoods"},
      {"honourable", "honorable"}, {"favourable", "favorable"},
      {"behavioural", "behavioral"}, {"labourer", "laborer"},
      {"labourers", "laborers"}, {"odour", "odor"}, {"odours", "odors"},
      {"centre", "center"}, {"centres", "centers"}, {"centred", "centered"},
      {"theatre", "theater"}, {"theatres", "theaters"},
      {"litre", "liter"}, {"litres", "liters"},
      {"metre", "meter"}, {"metres", "meters"},
      {"fibre", "fiber"}, {"fibres", "fibers"},
      {"calibre", "caliber"}, {"sombre", "somber"}, {"lustre", "luster"},
      {"spectre", "specter"}, {"spectres", "specters"},
      {"sabre", "saber"}, {"sabres", "sabers"},
      {"manoeuvre", "maneuver"}, {"manoeuvres", "maneuvers"},
      {"programme", "program"}, {"programmes", "programs"},
  };
  static const std::set<std::string> kOurKeep = {
      "devour", "devours", "devoured", "devouring", "contour", "contours",
      "contoured", "contouring", "detour", "detours", "detoured", "detouring",
      "glamour", "glamours", "velour",
      "velours", "downpour", "downpours", "troubadour", "troubadours",
      "paramour", "paramours", "pompadour", "pompadours", "tambour",
      "tambours"};
  auto americanize = [](const std::string& t) -> std::string {
    auto it = kAmericanize.find(t);
    if (it != kAmericanize.end()) return it->second;
    if (kOurKeep.count(t)) return t;
    for (char c : t)
      if (!std::isalpha((unsigned char)c)) return t;
    static const char* sufs[] = {"ouring", "oured", "ours", "our"};  // longest first
    for (const char* suf : sufs) {
      size_t n = std::strlen(suf);
      if (t.size() >= n + 3 && t.compare(t.size() - n, n, suf) == 0)
        return t.substr(0, t.size() - n) + "or" + std::string(suf + 3);
    }
    return t;
  };
  std::istringstream iss(s);
  std::string tok, out;
  std::vector<std::string> raw;
  while (iss >> tok) raw.push_back(tok);
  auto emit = [&out](const std::string& t) {
    if (!out.empty()) out += ' ';
    out += t;
  };
  for (size_t i = 0; i < raw.size(); ++i) {
    const std::string& tk = raw[i];
    bool all_dots = tk.find_first_not_of('.') == std::string::npos;
    // PTBLexer's lookahead is character-level: contextual abbreviations only
    // keep the period when followed by a letter/digit token ("gal. of", not
    // "gal. ," / "in. -RRB-") — keep in sync with tokenizer.py
    bool followed_by_word =
        i + 1 < raw.size() && !raw[i + 1].empty() &&
        std::isalnum((unsigned char)raw[i + 1][0]);
    bool keep_abbrev = kAbbrevAlways.count(tk) ||
                       (kAbbrevContextual.count(tk) && followed_by_word);
    if (tk.size() > 1 && tk.back() == '.' && !all_dots && !keep_abbrev &&
        !(tk.size() == 2 && std::isalpha((unsigned char)tk[0])) &&
        !is_acronym(tk)) {
      emit(americanize(tk.substr(0, tk.size() - 1)));
      emit(".");
    } else {
      emit(americanize(tk));
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// Porter2 (Snowball English) stemmer — mirrors dlsg_tpu/metrics/stemmer.py
// ---------------------------------------------------------------------------

const std::string VOWELS = "aeiouy";
bool vowel(char c) { return VOWELS.find(c) != std::string::npos; }
bool ends_with(const std::string& w, const std::string& suf) {
  return w.size() >= suf.size() &&
         w.compare(w.size() - suf.size(), suf.size(), suf) == 0;
}

void regions(const std::string& w, size_t& r1, size_t& r2) {
  static const char* prefixes[] = {"gener", "commun", "arsen"};
  r1 = w.size();
  for (const char* p : prefixes) {
    size_t n = std::strlen(p);
    if (w.compare(0, n, p) == 0) { r1 = n; goto r2calc; }
  }
  for (size_t i = 1; i < w.size(); ++i)
    if (!vowel(w[i]) && vowel(w[i - 1])) { r1 = i + 1; break; }
r2calc:
  r2 = w.size();
  for (size_t i = r1 + 1; i < w.size(); ++i)
    if (!vowel(w[i]) && vowel(w[i - 1])) { r2 = i + 1; break; }
}

bool ends_short_syllable(const std::string& w) {
  if (w.size() == 2) return vowel(w[0]) && !vowel(w[1]);
  if (w.size() >= 3) {
    char a = w[w.size() - 3], b = w[w.size() - 2], c = w[w.size() - 1];
    return vowel(b) && !vowel(c) && c != 'w' && c != 'x' && c != 'Y' && !vowel(a);
  }
  return false;
}

bool is_short(const std::string& w, size_t r1) {
  return r1 >= w.size() && ends_short_syllable(w);
}

bool has_vowel(const std::string& w) {
  for (char c : w) if (vowel(c)) return true;
  return false;
}

std::string porter2(std::string w) {
  std::transform(w.begin(), w.end(), w.begin(),
                 [](unsigned char c) { return std::tolower(c); });
  if (w.size() <= 2) return w;

  struct Exc { const char* a; const char* b; };
  static const Exc exceptions[] = {
      {"skis", "ski"}, {"skies", "sky"}, {"dying", "die"}, {"lying", "lie"},
      {"tying", "tie"}, {"idly", "idl"}, {"gently", "gentl"}, {"ugly", "ugli"},
      {"early", "earli"}, {"only", "onli"}, {"singly", "singl"}, {"sky", "sky"},
      {"news", "news"}, {"howe", "howe"}, {"atlas", "atlas"},
      {"cosmos", "cosmos"}, {"bias", "bias"}, {"andes", "andes"},
  };
  for (const auto& e : exceptions)
    if (w == e.a) return e.b;

  if (w[0] == '\'') w = w.substr(1);
  if (w[0] == 'y') w[0] = 'Y';
  for (size_t i = 1; i < w.size(); ++i)
    if (w[i] == 'y' && vowel(w[i - 1])) w[i] = 'Y';
  size_t r1, r2;
  regions(w, r1, r2);

  // step 0
  for (const char* suf : {"'s'", "'s", "'"}) {
    if (ends_with(w, suf)) { w.resize(w.size() - std::strlen(suf)); break; }
  }

  // step 1a
  if (ends_with(w, "sses")) w.resize(w.size() - 2);
  else if (ends_with(w, "ied") || ends_with(w, "ies"))
    w.resize(w.size() - (w.size() > 4 ? 2 : 1));
  else if (ends_with(w, "us") || ends_with(w, "ss")) {}
  else if (ends_with(w, "s")) {
    std::string head = w.substr(0, w.size() >= 2 ? w.size() - 2 : 0);
    if (has_vowel(head)) w.resize(w.size() - 1);
  }

  for (const char* stop : {"inning", "outing", "canning", "herring", "earring",
                           "proceed", "exceed", "succeed"}) {
    if (w == stop) {
      std::string lo = w;
      std::transform(lo.begin(), lo.end(), lo.begin(),
                     [](unsigned char c) { return std::tolower(c); });
      return lo;
    }
  }

  // step 1b
  bool done_1b = false;
  for (const char* suf : {"eedly", "eed"}) {
    if (ends_with(w, suf)) {
      size_t n = std::strlen(suf);
      if (w.size() - n >= r1) { w.resize(w.size() - n); w += "ee"; }
      done_1b = true;
      break;
    }
  }
  if (!done_1b) {
    static const char* DOUBLES[] = {"bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt"};
    for (const char* suf : {"ingly", "edly", "ing", "ed"}) {
      if (ends_with(w, suf)) {
        size_t n = std::strlen(suf);
        std::string stem = w.substr(0, w.size() - n);
        if (has_vowel(stem)) {
          w = stem;
          bool dbl = false;
          for (const char* d : DOUBLES)
            if (ends_with(w, d)) { dbl = true; break; }
          if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz")) w += "e";
          else if (dbl) w.resize(w.size() - 1);
          else if (is_short(w, r1)) w += "e";
        }
        break;
      }
    }
  }

  // step 1c
  if (w.size() > 2 && (w.back() == 'y' || w.back() == 'Y') &&
      !vowel(w[w.size() - 2]))
    w[w.size() - 1] = 'i';

  // step 2
  struct Map { const char* suf; const char* rep; };
  static const Map step2[] = {
      {"ization", "ize"}, {"ational", "ate"}, {"fulness", "ful"},
      {"ousness", "ous"}, {"iveness", "ive"}, {"tional", "tion"},
      {"biliti", "ble"},  {"lessli", "less"}, {"entli", "ent"},
      {"ation", "ate"},   {"alism", "al"},    {"aliti", "al"},
      {"ousli", "ous"},   {"iviti", "ive"},   {"fulli", "ful"},
      {"enci", "ence"},   {"anci", "ance"},   {"abli", "able"},
      {"izer", "ize"},    {"ator", "ate"},    {"alli", "al"},
      {"bli", "ble"},
  };
  bool matched2 = false;
  for (const auto& m : step2) {
    if (ends_with(w, m.suf)) {
      size_t n = std::strlen(m.suf);
      if (w.size() - n >= r1) { w.resize(w.size() - n); w += m.rep; }
      matched2 = true;
      break;
    }
  }
  if (!matched2) {
    const std::string li = "cdeghkmnrt";
    if (ends_with(w, "ogi") && w.size() >= 4 && w[w.size() - 4] == 'l' &&
        w.size() - 3 >= r1)
      w.resize(w.size() - 1);
    else if (ends_with(w, "li") && w.size() >= 3 && w.size() - 2 >= r1 &&
             li.find(w[w.size() - 3]) != std::string::npos)
      w.resize(w.size() - 2);
  }

  // step 3
  static const Map step3[] = {
      {"ational", "ate"}, {"tional", "tion"}, {"alize", "al"},
      {"icate", "ic"},    {"iciti", "ic"},    {"ical", "ic"},
      {"ness", ""},       {"ful", ""},
  };
  bool matched3 = false;
  for (const auto& m : step3) {
    if (ends_with(w, m.suf)) {
      size_t n = std::strlen(m.suf);
      if (w.size() - n >= r1) { w.resize(w.size() - n); w += m.rep; }
      matched3 = true;
      break;
    }
  }
  if (!matched3 && ends_with(w, "ative") && w.size() - 5 >= r2)
    w.resize(w.size() - 5);

  // step 4
  static const char* step4[] = {
      "ement", "ance", "ence", "able", "ible", "ment", "ant", "ent",
      "ism", "ate", "iti", "ous", "ive", "ize", "al", "er", "ic",
  };
  bool matched4 = false;
  for (const char* suf : step4) {
    if (ends_with(w, suf)) {
      size_t n = std::strlen(suf);
      if (w.size() - n >= r2) w.resize(w.size() - n);
      matched4 = true;
      break;
    }
  }
  if (!matched4 && ends_with(w, "ion") && w.size() >= 4 && w.size() - 3 >= r2 &&
      (w[w.size() - 4] == 's' || w[w.size() - 4] == 't'))
    w.resize(w.size() - 3);

  // step 5
  if (ends_with(w, "e")) {
    std::string head = w.substr(0, w.size() - 1);
    if (w.size() - 1 >= r2 || (w.size() - 1 >= r1 && !ends_short_syllable(head)))
      w.resize(w.size() - 1);
  } else if (ends_with(w, "ll") && w.size() - 1 >= r2) {
    w.resize(w.size() - 1);
  }

  std::transform(w.begin(), w.end(), w.begin(),
                 [](unsigned char c) { return std::tolower(c); });
  return w;
}

// ---------------------------------------------------------------------------
// METEOR aligner — mirrors dlsg_tpu/metrics/meteor.py exactly: exact > stem >
// synonym > paraphrase stages (METEOR 1.5's four match stages, English
// weights 1.0/0.6/0.8/0.6), then the official beam search over partial alignments
// (maximize matches, minimize chunks, minimize distance; beam 40), including
// the Python side's deterministic matchlist tie-break.
// ---------------------------------------------------------------------------

const double STAGE_WEIGHTS[4] = {1.0, 0.6, 0.8, 0.6};
const double DELTA = 0.75;
const int BEAM_WIDTH = 40;

const std::set<std::string>& default_function_words() {
  static const std::set<std::string> fw = {
      "a","an","the","this","that","these","those","some","any","each","every",
      "no","all","both","half","i","you","he","she","it","we","they","me","him",
      "her","us","them","my","your","his","its","our","their","is","am","are",
      "was","were","be","been","being","do","does","did","have","has","had",
      "will","would","shall","should","may","might","can","could","must","of",
      "in","on","at","by","for","with","about","against","between","into",
      "through","during","before","after","above","below","to","from","up",
      "down","out","off","over","under","again","further","then","once","here",
      "there","when","where","why","how","and","or","but","if","because","as",
      "until","while","not","so","than","too","very","s","t","just","don","now"};
  return fw;
}

std::set<std::string>& function_words() {
  static std::set<std::string> fw = default_function_words();
  return fw;
}

double word_weight(const std::string& w) {
  return function_words().count(w) ? (1.0 - DELTA) : DELTA;
}

std::vector<std::string> split_ws(const std::string& s) {
  std::istringstream iss(s);
  std::vector<std::string> out;
  std::string tok;
  while (iss >> tok) out.push_back(tok);
  return out;
}

// word -> equivalents (loaded from the shipped synonyms.txt /
// paraphrases.txt via dlsg_meteor_load_synonyms / _load_paraphrases;
// symmetric by construction)
typedef std::map<std::string, std::set<std::string>> EquivTable;

EquivTable& synonym_table() {
  static EquivTable table;
  return table;
}

EquivTable& paraphrase_table() {
  static EquivTable table;
  return table;
}

// phrase (space-joined words) -> equivalent phrases; plus the longest phrase
// length in words (bounds span enumeration). Mirrors meteor.py get_phrase_table.
EquivTable& phrase_table() {
  static EquivTable table;
  return table;
}
int& phrase_max_len() {
  static int n = 0;
  return n;
}

bool table_hit(const EquivTable& tab, const std::string& a,
               const std::string& b) {
  auto it = tab.find(a);
  if (it != tab.end() && it->second.count(b)) return true;
  it = tab.find(b);
  return it != tab.end() && it->second.count(a);
}

// Stages 2/3 look up both surface forms and stems (the tables list lemmas;
// METEOR's WordNet stage likewise lemmatizes before synset lookup).
int match_stage(const std::string& h, const std::string& r,
                const std::string& hs, const std::string& rs) {
  if (h == r) return 0;
  if (hs == rs) return 1;
  const auto& syn = synonym_table();
  if (table_hit(syn, h, r) || table_hit(syn, hs, rs)) return 2;
  const auto& para = paraphrase_table();
  if (table_hit(para, h, r) || table_hit(para, hs, rs)) return 3;
  return -1;
}

// A match is a span pair: (hyp_start, ref_start, hyp_len, ref_len, stage).
// Single words for stages 0-3 word matches; multi-word spans for phrase
// paraphrases (stage 3). Mirrors meteor.py::_align exactly.
typedef std::array<int, 5> Match;

struct AlignState {
  unsigned long long used;  // ref bitmask (ref length capped at 64)
  int last_i, last_j;       // final word indices of the latest match
  int next_i;               // first hyp index not covered by a span match
  int words, chunks;        // words = hyp coverage + ref coverage
  long dist;
  std::vector<Match> matchlist;

  // METEOR objective + deterministic matchlist tie-break
  // (mirrors meteor.py::_state_rank)
  bool rank_less(const AlignState& o) const {
    if (words != o.words) return words > o.words;
    if (chunks != o.chunks) return chunks < o.chunks;
    if (dist != o.dist) return dist < o.dist;
    return matchlist < o.matchlist;
  }
};

std::string join_span(const std::vector<std::string>& w, size_t a, size_t len) {
  std::string out = w[a];
  for (size_t k = 1; k < len; ++k) { out += ' '; out += w[a + k]; }
  return out;
}

std::vector<Match> beam_align(
    const std::vector<std::string>& hyp, const std::vector<std::string>& ref) {
  std::vector<std::string> hyp_stem(hyp.size()), ref_stem(ref.size());
  for (size_t i = 0; i < hyp.size(); ++i) hyp_stem[i] = porter2(hyp[i]);
  for (size_t j = 0; j < ref.size(); ++j) ref_stem[j] = porter2(ref[j]);

  std::vector<std::vector<std::pair<int, int>>> cands(hyp.size());
  for (size_t i = 0; i < hyp.size(); ++i)
    for (size_t j = 0; j < ref.size() && j < 64; ++j) {
      int s = match_stage(hyp[i], ref[j], hyp_stem[i], ref_stem[j]);
      if (s >= 0) cands[i].push_back({(int)j, s});
    }

  // phrase-span candidates: hyp_start -> (ref_start, hyp_len, ref_len);
  // at least one side multi-word (mirrors meteor.py::_phrase_candidates)
  std::vector<std::vector<std::array<int, 3>>> spans(hyp.size());
  const EquivTable& phrases = phrase_table();
  if (!phrases.empty()) {
    int max_len = phrase_max_len();
    std::map<std::string, std::vector<std::pair<int, int>>> ref_spans;
    for (size_t j = 0; j < ref.size() && j < 64; ++j)
      for (size_t rl = 1; rl <= (size_t)max_len && j + rl <= ref.size() && j + rl <= 64; ++rl)
        ref_spans[join_span(ref, j, rl)].push_back({(int)j, (int)rl});
    for (size_t i = 0; i < hyp.size(); ++i)
      for (size_t hl = 1; hl <= (size_t)max_len && i + hl <= hyp.size(); ++hl) {
        auto it = phrases.find(join_span(hyp, i, hl));
        if (it == phrases.end()) continue;
        for (const auto& ph : it->second) {
          auto rit = ref_spans.find(ph);
          if (rit == ref_spans.end()) continue;
          for (const auto& [j, rl] : rit->second)
            if ((int)hl + rl >= 3) spans[i].push_back({j, (int)hl, rl});
        }
      }
  }

  std::vector<AlignState> beam = {{0ULL, -2, -2, 0, 0, 0, 0, {}}};
  for (size_t i = 0; i < hyp.size(); ++i) {
    if (cands[i].empty() && spans[i].empty()) continue;
    // dedupe by (used, last_i, last_j, next_i), keeping the best-ranked state
    std::map<std::tuple<unsigned long long, int, int, int>, AlignState> extended;
    auto consider = [&](const AlignState& st) {
      auto key = std::make_tuple(st.used, st.last_i, st.last_j, st.next_i);
      auto it = extended.find(key);
      if (it == extended.end() || st.rank_less(it->second)) extended[key] = st;
    };
    for (const auto& st : beam) {
      if (st.next_i > (int)i) {  // inside an earlier span match: pass through
        consider(st);
        continue;
      }
      AlignState pass = st;  // hyp[i] left unmatched
      pass.next_i = (int)i + 1;
      consider(pass);
      for (const auto& [j, s] : cands[i]) {
        unsigned long long bit = 1ULL << j;
        if (st.used & bit) continue;
        AlignState nx = st;
        nx.used |= bit;
        nx.chunks += (st.last_i == (int)i - 1 && st.last_j == j - 1) ? 0 : 1;
        nx.last_i = (int)i;
        nx.last_j = j;
        nx.next_i = (int)i + 1;
        nx.words += 2;
        nx.dist += std::labs((long)i - (long)j);
        nx.matchlist.push_back({(int)i, j, 1, 1, s});
        consider(nx);
      }
      for (const auto& sp : spans[i]) {
        int j = sp[0], hl = sp[1], rl = sp[2];
        unsigned long long mask = (rl >= 64 ? ~0ULL : ((1ULL << rl) - 1)) << j;
        if (st.used & mask) continue;
        AlignState nx = st;
        nx.used |= mask;
        nx.chunks += (st.last_i == (int)i - 1 && st.last_j == j - 1) ? 0 : 1;
        nx.last_i = (int)i + hl - 1;
        nx.last_j = j + rl - 1;
        nx.next_i = (int)i + hl;
        nx.words += hl + rl;
        nx.dist += std::labs((long)i - (long)j);
        nx.matchlist.push_back({(int)i, j, hl, rl, 3});
        consider(nx);
      }
    }
    beam.clear();
    for (auto& kv : extended) beam.push_back(std::move(kv.second));
    std::sort(beam.begin(), beam.end(),
              [](const AlignState& a, const AlignState& b) { return a.rank_less(b); });
    if ((int)beam.size() > BEAM_WIDTH) beam.resize(BEAM_WIDTH);
  }

  const AlignState* best = &beam[0];
  for (const auto& st : beam)
    if (st.rank_less(*best)) best = &st;
  return best->matchlist;
}

}  // namespace

extern "C" {

// Tokenize `line`; writes space-joined tokens into out (cap bytes). Returns
// the full length needed, or -1 on error.
int dlsg_ptb_tokenize(const char* line, int lowercase, char* out, int cap) {
  if (!line || !out) return -1;
  std::string res = ptb_tokenize(line, lowercase != 0);
  int n = (int)res.size();
  if (n + 1 <= cap) std::memcpy(out, res.c_str(), n + 1);
  return n;
}

// Stem one word into out (cap bytes). Returns length needed.
int dlsg_porter2_stem(const char* word, char* out, int cap) {
  if (!word || !out) return -1;
  std::string res = porter2(word);
  int n = (int)res.size();
  if (n + 1 <= cap) std::memcpy(out, res.c_str(), n + 1);
  return n;
}

// Load an equivalence-groups file (the synonyms.txt/paraphrases.txt format).
// Returns the number of distinct words in the table, or -1 on error.
int load_groups_file(const char* path, EquivTable& table) {
  if (!path) return -1;
  std::ifstream f(path);
  if (!f) return -1;
  table.clear();
  std::string line;
  while (std::getline(f, line)) {
    size_t hash = line.find('#');
    if (hash != std::string::npos) line.resize(hash);
    std::vector<std::string> words = split_ws(line);
    if (words.size() < 2) continue;
    for (const auto& w : words)
      for (const auto& x : words)
        if (w != x) table[w].insert(x);
  }
  return (int)table.size();
}

int dlsg_meteor_load_synonyms(const char* path) {
  return load_groups_file(path, synonym_table());
}

// Load a function-word list (whitespace-separated words, '#' comments),
// REPLACING the built-in list (mirrors meteor.py set_function_words).
// Returns the list size, or -1 on error.
int dlsg_meteor_load_function_words(const char* path) {
  if (!path) return -1;
  std::ifstream f(path);
  if (!f) return -1;
  std::set<std::string>& fw = function_words();
  fw.clear();
  std::string line;
  while (std::getline(f, line)) {
    size_t hash = line.find('#');
    if (hash != std::string::npos) line.resize(hash);
    for (const auto& w : split_ws(line)) fw.insert(w);
  }
  return (int)fw.size();
}

// Restore the built-in function-word list. Returns its size.
int dlsg_meteor_reset_function_words() {
  function_words() = default_function_words();
  return (int)function_words().size();
}

int dlsg_meteor_load_paraphrases(const char* path) {
  return load_groups_file(path, paraphrase_table());
}

// Load a phrase-groups file: '|||'-separated phrase groups, one per line,
// '#' comments (the metrics/data/phrase_paraphrases.txt format — mirrors
// meteor.py::_load_phrases_file).
int dlsg_meteor_load_phrases(const char* path) {
  if (!path) return -1;
  std::ifstream f(path);
  if (!f) return -1;
  EquivTable& table = phrase_table();
  table.clear();
  phrase_max_len() = 0;
  std::string line;
  while (std::getline(f, line)) {
    size_t hash = line.find('#');
    if (hash != std::string::npos) line.resize(hash);
    std::vector<std::string> phrases;
    size_t pos = 0;
    while (pos <= line.size()) {
      size_t sep = line.find("|||", pos);
      std::string part = line.substr(pos, sep == std::string::npos ? std::string::npos : sep - pos);
      // normalize internal whitespace (like ' '.join(p.split()))
      std::vector<std::string> words = split_ws(part);
      if (!words.empty()) phrases.push_back(join_span(words, 0, words.size()));
      if (sep == std::string::npos) break;
      pos = sep + 3;
    }
    if (phrases.size() < 2) continue;
    for (const auto& p : phrases) {
      int n = 1;
      for (char c : p) n += (c == ' ');
      phrase_max_len() = std::max(phrase_max_len(), n);
    }
    for (const auto& a : phrases)
      for (const auto& b : phrases)
        if (a != b) table[a].insert(b);
  }
  return (int)table.size();
}

// METEOR segment statistics for hyp vs one ref (both space-tokenized).
// stats[6] = {wp_num, wp_den, wr_num, wr_den, chunks, matches}.
// Beam-search alignment identical to metrics/meteor.py::_align.
// Returns -1 when the pair exceeds the native fast path's limits (ref > 64
// words) so the caller falls back to the Python implementation.
int dlsg_meteor_stats(const char* hyp_s, const char* ref_s, double* stats) {
  if (!hyp_s || !ref_s || !stats) return -1;
  std::vector<std::string> hyp = split_ws(hyp_s), ref = split_ws(ref_s);
  if (ref.size() > 64) return -1;  // bitmask limit; Python handles the rest

  std::vector<Match> matches = beam_align(hyp, ref);

  double wp_num = 0, wr_num = 0, wp_den = 0, wr_den = 0;
  long cov_h = 0, cov_r = 0;
  for (const auto& m : matches) {
    for (int k = 0; k < m[2]; ++k)
      wp_num += STAGE_WEIGHTS[m[4]] * word_weight(hyp[m[0] + k]);
    for (int k = 0; k < m[3]; ++k)
      wr_num += STAGE_WEIGHTS[m[4]] * word_weight(ref[m[1] + k]);
    cov_h += m[2];
    cov_r += m[3];
  }
  for (const auto& w : hyp) wp_den += word_weight(w);
  for (const auto& w : ref) wr_den += word_weight(w);

  // chunk: successor contiguous when both spans abut on both sides
  int chunks = matches.empty() ? 0 : 1;
  for (size_t k = 1; k < matches.size(); ++k) {
    if (!(matches[k][0] == matches[k - 1][0] + matches[k - 1][2] &&
          matches[k][1] == matches[k - 1][1] + matches[k - 1][3]))
      ++chunks;
  }
  if (!matches.empty() && chunks == 1 && cov_h == (long)hyp.size() &&
      cov_r == (long)ref.size())
    chunks = 0;

  stats[0] = wp_num;
  stats[1] = wp_den;
  stats[2] = wr_num;
  stats[3] = wr_den;
  stats[4] = (double)chunks;
  stats[5] = (cov_h + cov_r) / 2.0;  // frag denominator: avg covered words
  return 0;
}

}  // extern "C"
