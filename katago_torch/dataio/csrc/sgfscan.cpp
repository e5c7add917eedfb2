// Main-line scan of an SGF text: the port's C++ counterpart of
// katago_torch/dataio/sgfscan.py::scan_sgf_plain (the Python parser of
// dataio/sgf.py plus SgfGame's fields), built at first use by
// katago_torch/ops/_hostbuild.py and called through ctypes.
//
// It accepts and refuses exactly what the parser does: every game of the
// text must parse (the summary is the first game's), a property ident is
// a run of upper-case letters followed by at least one [value], a value
// ends at the first unescaped ']', and whitespace is Python's
// str.isspace(). The fields are evaluated in the order scan_sgf_plain
// evaluates them (SZ, RE, KM, HA, the names, the moves, the setup
// stones), so a record on which Python raises gives the same kind of
// error. Two things the library does not decide, and hands back to the
// caller (KT_PARSER): a non-ASCII character where a property ident may
// stand (Python's Unicode letter classes decide there) or inside a
// number (Python's int() and float() read Unicode digits), and trees
// nested deeper than MAX_DEPTH (the parser's recursion limit decides).
//
// Text is UTF-8. Locations follow dataio/sgf.py: y * x_size + x, and
// x_size * y_size for a pass.

#include <locale.h>
#include <stdlib.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status {
  KT_OK = 0,
  KT_MALFORMED = 1,   // the parser refuses the text: no summary
  KT_VALUE_ERROR = 2, // int() / float() / str.index() raise ValueError
  KT_SGF_ERROR = 3,   // parse_sgf_loc raises SgfError
  KT_PARSER = 4,      // the caller must ask the parser
  KT_OVERFLOW = 5,    // an output buffer is too small
};

constexpr int MAX_DEPTH = 200;
constexpr int64_t MAX_INT = 1000000000;  // larger numbers: KT_PARSER

struct Fail {
  int status;
};

// One main-line node's values that the summary reads.
struct MainNode {
  bool has_b = false, has_w = false;
  std::string b, w;
  std::vector<std::string> ab, aw;
};

struct Root {
  bool has[6] = {false, false, false, false, false, false};
  std::string val[6];  // SZ, KM, HA, RE, PB, PW: each the first value
};
const char *ROOT_KEYS[6] = {"SZ", "KM", "HA", "RE", "PB", "PW"};

// Python's str.isspace() of the code point at p (UTF-8); sets len.
bool is_space(const unsigned char *p, const unsigned char *end, int *len) {
  unsigned c = p[0];
  *len = 1;
  if (c < 0x80)
    return c == ' ' || (c >= 0x09 && c <= 0x0d) || (c >= 0x1c && c <= 0x1f);
  unsigned cp;
  int n;
  if ((c & 0xe0) == 0xc0) { cp = c & 0x1f; n = 2; }
  else if ((c & 0xf0) == 0xe0) { cp = c & 0x0f; n = 3; }
  else if ((c & 0xf8) == 0xf0) { cp = c & 0x07; n = 4; }
  else return false;
  if (end - p < n) return false;
  for (int i = 1; i < n; i++) cp = (cp << 6) | (p[i] & 0x3f);
  *len = n;
  return cp == 0x85 || cp == 0xa0 || cp == 0x1680 ||
         (cp >= 0x2000 && cp <= 0x200a) || cp == 0x2028 || cp == 0x2029 ||
         cp == 0x202f || cp == 0x205f || cp == 0x3000;
}

class Scanner {
 public:
  Scanner(const unsigned char *text, int64_t n) : t_(text), n_(n) {}

  // parse_sgf: every game; the first one's main line is recorded.
  void parse() {
    int64_t pos = 0;
    int games = 0;
    while (true) {
      while (pos < n_ && t_[pos] != '(') pos++;
      if (pos >= n_) break;
      pos = tree(pos, games == 0, 1);
      games++;
    }
    if (games == 0) throw Fail{KT_MALFORMED};
  }

  Root root;
  std::vector<MainNode> main;

 private:
  const unsigned char *t_;
  int64_t n_;

  // Skip Python whitespace from pos.
  int64_t skip_space(int64_t pos) {
    int len;
    while (pos < n_ && is_space(t_ + pos, t_ + n_, &len)) pos += len;
    return pos;
  }

  // _parse_tree at t_[pos] == '('; main: its first node continues the
  // main line. Returns the position after its ')'.
  int64_t tree(int64_t pos, bool main_first, int depth) {
    if (depth > MAX_DEPTH) throw Fail{KT_PARSER};
    pos++;
    bool have_cur = false, cur_main = false;
    int64_t cur_children = 0;
    while (pos < n_) {
      int len;
      unsigned char c = t_[pos];
      if (is_space(t_ + pos, t_ + n_, &len)) {
        pos += len;
      } else if (c == ';') {
        bool node_main = have_cur ? (cur_main && cur_children == 0)
                                  : main_first;
        if (have_cur) cur_children++;
        pos = node(pos + 1, node_main, !have_cur && main_first &&
                   main.empty());
        have_cur = true;
        cur_main = node_main;
        cur_children = 0;
      } else if (c == '(') {
        if (!have_cur) throw Fail{KT_MALFORMED};
        bool sub_main = cur_main && cur_children == 0;
        cur_children++;
        pos = tree(pos, sub_main, depth + 1);
      } else if (c == ')') {
        if (!have_cur) throw Fail{KT_MALFORMED};
        return pos + 1;
      } else {
        throw Fail{KT_MALFORMED};
      }
    }
    throw Fail{KT_MALFORMED};
  }

  // _parse_node from pos (after ';'); records a main-line node's values.
  int64_t node(int64_t pos, bool is_main, bool is_root) {
    MainNode rec;
    while (pos < n_) {
      pos = skip_space(pos);
      if (pos >= n_ || t_[pos] == ';' || t_[pos] == '(' || t_[pos] == ')')
        break;
      int64_t start = pos;
      bool lower = false;
      while (pos < n_ && ((t_[pos] >= 'A' && t_[pos] <= 'Z') ||
                          (t_[pos] >= 'a' && t_[pos] <= 'z'))) {
        lower |= t_[pos] >= 'a';
        pos++;
      }
      // a non-ASCII letter would extend the ident (str.isalpha)
      int len;
      if (pos < n_ && t_[pos] >= 0x80 && !is_space(t_ + pos, t_ + n_, &len))
        throw Fail{KT_PARSER};
      if (pos == start || lower) throw Fail{KT_MALFORMED};
      std::string ident(reinterpret_cast<const char *>(t_ + start),
                        pos - start);
      int nvals = 0;
      while (true) {
        pos = skip_space(pos);
        if (pos >= n_ || t_[pos] != '[') break;
        pos++;
        std::string buf;
        while (pos < n_ && t_[pos] != ']') {
          if (t_[pos] == '\\' && pos + 1 < n_) pos++;
          buf.push_back(static_cast<char>(t_[pos]));
          pos++;
        }
        if (pos >= n_) throw Fail{KT_MALFORMED};
        pos++;
        if (is_main) record(&rec, ident, buf, is_root);
        nvals++;
      }
      if (nvals == 0) throw Fail{KT_MALFORMED};
    }
    if (is_main) main.push_back(std::move(rec));
    return pos;
  }

  void record(MainNode *rec, const std::string &ident, std::string &val,
              bool is_root) {
    if (is_root) {
      for (int k = 0; k < 6; k++)
        if (ident == ROOT_KEYS[k] && !root.has[k]) {
          root.has[k] = true;
          root.val[k] = val;
        }
    }
    if (ident == "B" && !rec->has_b) { rec->has_b = true; rec->b = val; }
    else if (ident == "W" && !rec->has_w) { rec->has_w = true; rec->w = val; }
    else if (ident == "AB") rec->ab.push_back(val);
    else if (ident == "AW") rec->aw.push_back(val);
  }
};

bool ascii_space(char c) {
  return c == ' ' || (c >= 0x09 && c <= 0x0d);
}

bool has_non_ascii(const std::string &s) {
  for (unsigned char c : s)
    if (c >= 0x80) return true;
  return false;
}

// s without Python's int()/float() surrounding whitespace.
std::string strip(const std::string &s) {
  size_t a = 0, b = s.size();
  while (a < b && ascii_space(s[a])) a++;
  while (b > a && ascii_space(s[b - 1])) b--;
  return s.substr(a, b - a);
}

// Digits with single underscores between them, from i; appends the
// digits to out and returns the index after them (i when none).
size_t digit_part(const std::string &s, size_t i, std::string *out) {
  if (i >= s.size() || s[i] < '0' || s[i] > '9') return i;
  while (true) {
    out->push_back(s[i++]);
    if (i < s.size() && s[i] >= '0' && s[i] <= '9') continue;
    if (i + 1 < s.size() && s[i] == '_' && s[i + 1] >= '0' &&
        s[i + 1] <= '9') {
      i++;
      continue;
    }
    return i;
  }
}

// Python int(s) (base 10, ASCII).
int64_t py_int(const std::string &raw) {
  if (has_non_ascii(raw)) throw Fail{KT_PARSER};
  std::string s = strip(raw), digits;
  size_t i = 0;
  bool neg = false;
  if (i < s.size() && (s[i] == '+' || s[i] == '-')) neg = s[i++] == '-';
  size_t j = digit_part(s, i, &digits);
  if (j == i || j != s.size()) throw Fail{KT_VALUE_ERROR};
  size_t k = 0;
  while (k + 1 < digits.size() && digits[k] == '0') k++;
  if (digits.size() - k > 10) throw Fail{KT_PARSER};
  int64_t v = strtoll(digits.c_str() + k, nullptr, 10);
  if (v > MAX_INT) throw Fail{KT_PARSER};
  return neg ? -v : v;
}

bool iequals(const std::string &a, const char *b) {
  if (a.size() != std::strlen(b)) return false;
  for (size_t i = 0; i < a.size(); i++) {
    char c = a[i];
    if (c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
    if (c != b[i]) return false;
  }
  return true;
}

// Python float(s) (ASCII).
double py_float(const std::string &raw) {
  if (has_non_ascii(raw)) throw Fail{KT_PARSER};
  std::string s = strip(raw), clean;
  size_t i = 0;
  if (i < s.size() && (s[i] == '+' || s[i] == '-')) clean.push_back(s[i++]);
  std::string rest = s.substr(i);
  if (iequals(rest, "inf") || iequals(rest, "infinity"))
    return clean == "-" ? -INFINITY : INFINITY;
  if (iequals(rest, "nan")) return NAN;
  size_t j = digit_part(s, i, &clean);
  bool mant = j > i;
  if (j < s.size() && s[j] == '.') {
    clean.push_back('.');
    size_t k = digit_part(s, j + 1, &clean);
    mant |= k > j + 1;
    j = k;
  }
  if (!mant) throw Fail{KT_VALUE_ERROR};
  if (j < s.size() && (s[j] == 'e' || s[j] == 'E')) {
    clean.push_back('e');
    j++;
    if (j < s.size() && (s[j] == '+' || s[j] == '-')) clean.push_back(s[j++]);
    size_t k = digit_part(s, j, &clean);
    if (k == j) throw Fail{KT_VALUE_ERROR};
    j = k;
  }
  if (j != s.size()) throw Fail{KT_VALUE_ERROR};
  // correctly rounded, as Python's; "C" whatever the process's locale
  static locale_t c_locale = newlocale(LC_ALL_MASK, "C", nullptr);
  return strtod_l(clean.c_str(), nullptr, c_locale);
}

// Code points of a UTF-8 string.
size_t code_points(const std::string &s) {
  size_t n = 0;
  for (unsigned char c : s)
    if ((c & 0xc0) != 0x80) n++;
  return n;
}

// parse_sgf_loc
int64_t sgf_loc(const std::string &v, int64_t xs, int64_t ys) {
  int64_t nn = xs * ys;
  if (v.empty()) return nn;
  if (v == "tt" && xs <= 19 && ys <= 19) return nn;
  if (code_points(v) != 2) throw Fail{KT_SGF_ERROR};
  // _SGF_COORDS.index(): a character outside a-z raises ValueError
  if (v.size() != 2 || v[0] < 'a' || v[0] > 'z' || v[1] < 'a' ||
      v[1] > 'z')
    throw Fail{KT_VALUE_ERROR};
  int64_t x = v[0] - 'a', y = v[1] - 'a';
  if (x >= xs || y >= ys) throw Fail{KT_SGF_ERROR};
  return y * xs + x;
}

}  // namespace

extern "C" {

// Scan text[0:len]. On KT_OK fills
//   ints   [x_size, y_size, handicap, result, n_moves, n_setup,
//           len(PB), len(PW)]
//   floats [komi, margin]
//   moves  n_moves pairs (player 1/2, loc); setup n_setup pairs
//   names  PB's bytes, then PW's
// with the capacities given (pairs for moves and setup, bytes for
// names). Returns a Status.
int kt_sgf_scan(const char *text, int64_t len, int64_t *ints,
                double *floats, int64_t *moves, int64_t moves_cap,
                int64_t *setup, int64_t setup_cap, char *names,
                int64_t names_cap) {
  try {
    Scanner sc(reinterpret_cast<const unsigned char *>(text), len);
    sc.parse();
    const Root &r = sc.root;
    // game.size
    int64_t xs = 19, ys = 19;
    if (r.has[0] && !r.val[0].empty()) {
      const std::string &sz = r.val[0];
      size_t colon = sz.find(':');
      if (colon != std::string::npos) {
        xs = py_int(sz.substr(0, colon));
        ys = py_int(sz.substr(colon + 1));
      } else {
        xs = ys = py_int(sz);
      }
    }
    // _result_code
    int64_t result = 0;
    double margin = 0.0;
    if (r.has[3]) {
      const std::string &re = r.val[3];
      auto up = [](char c) { return (c >= 'a' && c <= 'z') ? c - 32 : c; };
      if (re.size() >= 2 && up(re[0]) == 'B' && re[1] == '+') result = 1;
      else if (re.size() >= 2 && up(re[0]) == 'W' && re[1] == '+')
        result = 2;
      else if (re == "0" || iequals(re, "draw")) result = 3;
      if (result == 1 || result == 2) {
        try {
          margin = py_float(re.substr(2));
        } catch (const Fail &f) {
          if (f.status == KT_PARSER) throw;
          margin = 0.0;
        }
      }
    }
    double komi = (r.has[1] && !r.val[1].empty()) ? py_float(r.val[1]) : 7.5;
    int64_t handicap = (r.has[2] && !r.val[2].empty()) ? py_int(r.val[2]) : 0;
    int64_t nmoves = 0, nsetup = 0;
    for (const MainNode &nd : sc.main) {
      for (int k = 0; k < 2; k++) {
        if (!(k == 0 ? nd.has_b : nd.has_w)) continue;
        int64_t loc = sgf_loc(k == 0 ? nd.b : nd.w, xs, ys);
        if (nmoves >= moves_cap) return KT_OVERFLOW;
        moves[2 * nmoves] = k + 1;
        moves[2 * nmoves + 1] = loc;
        nmoves++;
      }
    }
    for (const MainNode &nd : sc.main) {
      for (int k = 0; k < 2; k++) {
        for (const std::string &v : k == 0 ? nd.ab : nd.aw) {
          int64_t loc = sgf_loc(v, xs, ys);
          if (loc >= xs * ys) continue;
          if (nsetup >= setup_cap) return KT_OVERFLOW;
          setup[2 * nsetup] = k + 1;
          setup[2 * nsetup + 1] = loc;
          nsetup++;
        }
      }
    }
    const std::string &pb = r.val[4], &pw = r.val[5];
    if (static_cast<int64_t>(pb.size() + pw.size()) > names_cap)
      return KT_OVERFLOW;
    std::memcpy(names, pb.data(), pb.size());
    std::memcpy(names + pb.size(), pw.data(), pw.size());
    int64_t out[8] = {xs, ys, handicap, result, nmoves, nsetup,
                      static_cast<int64_t>(pb.size()),
                      static_cast<int64_t>(pw.size())};
    std::memcpy(ints, out, sizeof(out));
    floats[0] = komi;
    floats[1] = margin;
    return KT_OK;
  } catch (const Fail &f) {
    return f.status;
  } catch (...) {
    return KT_PARSER;
  }
}

}  // extern "C"
